"""The ensemble cell's driver (``traffic/ensemble.py``) and readers on the CPU
at a test's size: ``tiny.ensemble`` runs and is correct, a member's answer
altered or two members' answers swapped comes out not correct, and the
metrics ``kdd99.ensemble`` reports are pinned."""
import json
import time
from pathlib import Path

import pytest
import torch

from plarbench.harness import Run, cell_metrics, find_cell, load_module, run_cell
from plarbench.profiling import Ops, Trace
from plarbench.tests._tiny import make_tree

REPO = Path(__file__).resolve().parents[2]
QUIET = dict(seconds=0.5, trace=False, device="cpu", log=lambda msg: None)
MEASURES = ("PR", "SCE", "LCE", "CCE")


@pytest.fixture(autouse=True)
def _jax_loaded_elsewhere(monkeypatch):
    """As in ``test_plarbench_harness.py``: other test files of this process
    load JAX; a real run's process is checked in a subprocess of its own."""
    from plarbench import harness

    monkeypatch.setattr(harness, "forbidden_modules", lambda: [])


def add_tiny_ensemble(root: Path) -> Path:
    """``make_tree``'s tree with the cell ``tiny.ensemble`` added as files
    (the metric lists name it already: ``make_tree`` copies every ``kdd99``
    entry)."""
    base = root / "plarbench"
    w = json.loads((REPO / "plarbench" / "workloads" / "kdd99.ensemble.json").read_text())
    w["config"] = "tiny"
    (base / "workloads" / "tiny.ensemble.json").write_text(json.dumps(w))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "tiny.ensemble", "config": "tiny", "traffic": "ensemble",
                               "chips": 1, "why": "a CPU test's size"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return add_tiny_ensemble(make_tree(tmp_path_factory.mktemp("bench")))


def test_the_cell_runs_and_is_correct(tree):
    r = run_cell(tree, find_cell(tree, "tiny.ensemble"), seed=2**33 + 5, **QUIET)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert set(r["checks"]) == {"granules_off", "core_off", "reduct_off", "unanswered"} | {
        f"theta_gap_{m}" for m in MEASURES}
    assert r["metrics"]["reduce_s"]["value"] > 0


def _member_altered(results):
    r = results[1]
    r.reduct = r.reduct[:-1] + [next(a for a in range(64) if a not in r.reduct)]
    return results


def _lce_cce_swapped(results):
    results[2], results[3] = results[3], results[2]
    return results


@pytest.mark.parametrize("fault", [_member_altered, _lce_cce_swapped])
def test_faults_come_out_not_correct(tree, monkeypatch, fault):
    from repro_torch.core import reduction

    inner = reduction.plar_reduce_ensemble
    monkeypatch.setattr(reduction, "plar_reduce_ensemble",
                        lambda *a, **kw: fault(inner(*a, **kw)))
    r = run_cell(tree, find_cell(tree, "tiny.ensemble"), seed=2**33 + 6, **QUIET)
    assert r is not None and r["correct"] is False, r["checks"]


def test_metrics_of_the_cell():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    names = lambda trace: [m["name"] for m in cell_metrics(bench, "kdd99.ensemble", trace)]  # noqa: E731
    assert names(False) == ["setup_s", "reduce_s", "peak_mem_GiB"]
    assert names(True) == ["granulate_s.reduce", "device_idle_pct.reduce",
                           "theta_full_s.reduce", "core_s.reduce", "ensemble_loop_s.reduce",
                           "ensemble_bodies.reduce", "ensemble_roofline_pct.reduce"]


def test_the_configuration_states_the_grid_the_mix_runs():
    """``configs/kdd99_ensemble.json`` states the deployment; the driver runs
    the mix's grid, and the two say the same.  The table is kdd99's: the
    schema is drawn from ``name``."""
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    cell = find_cell(REPO, "kdd99.ensemble")
    entry = next(c for c in bench["configs"] if c["name"] == cell.entry["config"])
    assert entry["file"] == f"plarbench/configs/{cell.entry['config']}.json"
    assert cell.config["heuristics"] == cell.params["measures"]
    assert cell.config["ensemble"] == cell.params["run"]
    kdd99 = json.loads((REPO / "plarbench" / "configs" / "kdd99.json").read_text())
    table_keys = ("name", "rows", "attrs", "n_dec", "v_max", "distinct_fraction", "redundancy",
                  "relevance", "noise")
    assert {k: cell.config[k] for k in table_keys} == {k: kdd99[k] for k in table_keys}


@pytest.fixture
def tracer():
    from repro_torch import obs

    t = obs.get_tracer()
    was = t.enabled
    from plarbench import program_spans  # noqa: F401  (turns the recorder on)
    t.clear()
    t.enable()
    yield t
    t.clear()
    t.enabled = was


def _reader(name):
    return load_module(REPO / "plarbench" / "metrics" / f"{name}.py", f"metric_{name}")


def _ensemble_run(t, base, *, traced=False, bodies=True):
    """Two jobs of one second at ``base`` and ``base + 2``, each with a
    0.4 s ``engine.dispatch_ensemble`` of 12 and 14 bodies; two members
    each, cores of 2 and 0 attributes, 3 and 5 iterations, 1,000 granules."""
    jobs = []
    for j in range(2):
        t0 = base + 2.0 * j
        args = {"configs": 2, "bodies": 12 + 2 * j} if bodies else {"configs": 2}
        t._record("engine.dispatch_ensemble", "X", t0 + 0.5, 0.4, args)
        jobs.append({"j": j, "ok": True, "t0": t0, "t2": t0 + 1.0, "granules": 1000,
                     "n_attrs": 41, "members": [{"core": [0, 1], "iterations": 3},
                                                {"core": [], "iterations": 5}]})
    tr = Trace(False, torch.device("cpu"))
    if traced:       # the device busy for the first quarter of every dispatch
        starts = [base + 2.0 * j + 0.5 for j in range(2)]
        tr.ops = Ops(starts, [s + 0.1 for s in starts], [0, 0], ["k"])
        tr._offset = 0.0
    return Run(cell=None, setup_s=0.0, window=(base - 1.0, base + 4.0), peak_window_bytes=1,
               record={"jobs": jobs}, trace=tr)


def test_readers_on_a_synthetic_run(tracer):
    from plarbench.counts import remaining_per_iteration, roofline_seconds, theta_bytes

    base = time.perf_counter() + 10.0
    run = _ensemble_run(tracer, base)
    assert _reader("ensemble_loop_s.reduce").read(run) == pytest.approx(0.4)
    assert _reader("ensemble_bodies.reduce").read(run) == pytest.approx(13.0)
    assert _reader("ensemble_roofline_pct.reduce").read(run) is None      # the untraced half
    traced = _ensemble_run(tracer, base + 10.0, traced=True)
    need = 2 * (theta_bytes(1000, remaining_per_iteration(41, 2, 3))
                + theta_bytes(1000, remaining_per_iteration(41, 0, 5)))
    assert _reader("ensemble_roofline_pct.reduce").read(traced) == pytest.approx(
        100.0 * roofline_seconds(need) / 0.2)


def test_readers_read_nothing_where_the_program_has_no_such_span(tracer):
    """A program without ``engine.dispatch_ensemble`` or its ``bodies``:
    each reader returns ``None`` and raises nothing."""
    base = time.perf_counter() + 10.0
    empty = _ensemble_run(tracer, base)
    tracer.clear()
    for name in ("ensemble_loop_s.reduce", "ensemble_bodies.reduce",
                 "ensemble_roofline_pct.reduce"):
        assert _reader(name).read(empty) is None
    no_bodies = _ensemble_run(tracer, base + 10.0, bodies=False)
    assert _reader("ensemble_bodies.reduce").read(no_bodies) is None
