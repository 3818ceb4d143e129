"""The mesh cell's driver (``traffic/mesh.py``), its configuration, its
readers and its collective count, on the CPU at a test's size.

``tiny.mesh4`` (``make_tree``'s tiny table under kdd99.mesh4's mesh, mix and
limits) runs end to end on 4 gloo ranks, each in a process of its own
(``_SCRIPT``, run as a subprocess with JAX and the JAX package made
unimportable, so a rank that loads either fails the run): it is correct;
a spawned rank killed mid-window, or an error on rank 0, ends the run
non-zero within its timeout, and no rank outlives it.
"""
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from plarbench.harness import Run, cell_metrics, find_cell, load_module
from plarbench.profiling import Ops, Trace
from plarbench.tests._tiny import make_tree, tiny_config
from plarbench.tests.test_plarbench_imports import _loaded

REPO = Path(__file__).resolve().parents[2]
NEW_METRICS = ("mesh_granulate_s.reduce", "mesh_core_s.reduce", "mesh_loop_s.reduce",
               "collective_GB.reduce", "collective_roofline_pct.reduce")
RUN_TIMEOUT_S = 120

_SCRIPT = """
import json, os, sys, threading, time
from pathlib import Path

def main(root, mode, seconds):
    from plarbench.harness import find_cell, format_result, run_cell
    if mode == "fail":                  # rank 0's call raises mid-window
        from repro_torch.core import distributed
        calls = []
        inner = distributed.plar_reduce_distributed
        def failing(*a, **k):
            calls.append(1)
            if len(calls) > 2:
                raise RuntimeError("rank 0 failed")
            return inner(*a, **k)
        distributed.plar_reduce_distributed = failing
    if mode == "kill":                  # a spawned rank killed mid-window
        import multiprocessing, signal
        def kill():
            while True:
                kids = multiprocessing.active_children()
                if len(kids) == 3 and os.path.exists(os.path.join(root, "window")):
                    time.sleep(1.0)
                    print("killing", kids[1].pid, file=sys.stderr, flush=True)
                    os.kill(kids[1].pid, signal.SIGKILL)
                    return
                time.sleep(0.05)
        threading.Thread(target=kill, daemon=True).start()

    def log(msg):
        print(msg, file=sys.stderr, flush=True)
        if msg.startswith("set-up "):
            import multiprocessing
            pids = [str(p.pid) for p in multiprocessing.active_children()]
            print("ranks " + " ".join(pids), file=sys.stderr, flush=True)
            Path(root, "window").touch()
    r = run_cell(Path(root), find_cell(Path(root), "tiny.mesh4"), seed=2**33 + 7,
                 seconds=float(seconds), trace=False, device="cpu", log=log)
    if r is not None:
        print(format_result(r), flush=True)

if __name__ == "__main__":
    main(*sys.argv[1:])
"""


def add_tiny_mesh4(root: Path) -> Path:
    """``make_tree``'s tree with the configuration ``tiny_mesh4`` (the tiny
    table under kdd99_mesh4's run) and the cell ``tiny.mesh4`` added as
    files (the metric lists name it already: ``make_tree`` copies every
    ``kdd99`` entry)."""
    base = root / "plarbench"
    cfg = tiny_config()
    mesh4 = json.loads((REPO / "plarbench" / "configs" / "kdd99_mesh4.json").read_text())
    cfg["run"] = mesh4["run"]
    (base / "configs" / "tiny_mesh4.json").write_text(json.dumps(cfg))
    w = json.loads((REPO / "plarbench" / "workloads" / "kdd99.mesh4.json").read_text())
    w["config"] = "tiny_mesh4"
    (base / "workloads" / "tiny.mesh4.json").write_text(json.dumps(w))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny_mesh4", "source": "test", "reduced": [],
                             "file": "plarbench/configs/tiny_mesh4.json", "why": "test"})
    bench["workloads"].append({"name": "tiny.mesh4", "config": "tiny_mesh4", "traffic": "mesh",
                               "chips": 4, "why": "a CPU test's size"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = add_tiny_mesh4(make_tree(tmp_path_factory.mktemp("bench")))
    shadow = root / "shadow"
    for name in ("jax", "repro"):
        (shadow / name).mkdir(parents=True)
        (shadow / name / "__init__.py").write_text(
            f"raise ImportError('{name} must not be imported by the benchmark')\n")
    (root / "mesh_run.py").write_text(_SCRIPT)
    return root


def _run(root: Path, mode: str, seconds: float):
    """``_SCRIPT`` in a subprocess; ``(returncode, stdout, stderr, seconds)``."""
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": os.pathsep.join([str(root / "shadow"), str(REPO / "src"), str(root)])}
    (root / "window").unlink(missing_ok=True)
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, str(root / "mesh_run.py"), str(root), mode, str(seconds)],
                       cwd=root, env=env, capture_output=True, text=True, timeout=RUN_TIMEOUT_S)
    return p.returncode, p.stdout, p.stderr, time.perf_counter() - t0


def _alive(pid: int) -> bool:
    """Whether process ``pid`` runs (a zombie has ended)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def test_the_cell_runs_and_is_correct(tree):
    rc, out, err, _ = _run(tree, "ok", 2.0)
    assert rc == 0, err[-4000:]
    r = json.loads(out.strip().splitlines()[-1])
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0 and r["device"]["count"] == 4
    assert set(r["checks"]) == {"granules_off", "core_off", "reduct_off", "unanswered",
                                "theta_gap"}
    assert set(r["metrics"]) == {"setup_s", "reduce_s"}           # no allocator off the card
    assert "mesh [4, 1]: 4 ranks on cpu" in err


@pytest.mark.parametrize("mode", ["kill", "fail"])
def test_a_failed_rank_ends_the_run(tree, mode):
    """A spawned rank killed mid-window (rank 0's watchdog), or rank 0's
    own call failing: the run ends non-zero, printing no result, long
    before its window would, and its ranks with it."""
    rc, out, err, seconds = _run(tree, mode, 60.0)
    assert rc not in (0, None) and out.strip() == "", err[-4000:]
    assert seconds < 45, err[-4000:]
    assert "refused: " in err          # the watchdog, or rank 0 itself, ended the run
    assert ("killing" in err) if mode == "kill" else ("rank 0 failed" in err)
    ranks = [int(p) for line in err.splitlines() if line.startswith("ranks ")
             for p in line.split()[1:]]
    assert len(ranks) == 3
    deadline = time.perf_counter() + 10.0
    while any(map(_alive, ranks)) and time.perf_counter() < deadline:
        time.sleep(0.1)
    left = [p for p in ranks if _alive(p)]
    for pid in left:
        os.kill(pid, signal.SIGKILL)
    assert left == []


def test_the_configuration_and_the_cell():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    cell = find_cell(REPO, "kdd99.mesh4")
    assert cell.entry["chips"] == 4 and cell.driver.__name__.endswith("traffic_mesh")
    entry = next(c for c in bench["configs"] if c["name"] == cell.entry["config"])
    assert entry["file"] == "plarbench/configs/kdd99_mesh4.json" and entry["reduced"] == ["mesh"]
    assert entry["source"] == cell.config["source"]
    assert list(cell.config["reduced"]) == ["mesh"]
    assert cell.config["run"]["mesh"] == [4, 1] and cell.config["run"]["delta"] == "SCE"
    kdd99 = json.loads((REPO / "plarbench" / "configs" / "kdd99.json").read_text())
    table_keys = ("name", "rows", "attrs", "n_dec", "v_max", "distinct_fraction", "redundancy",
                  "relevance", "noise", "assumed")
    assert {k: cell.config[k] for k in table_keys} == {k: kdd99[k] for k in table_keys}
    batch = find_cell(REPO, "kdd99.batch")
    assert set(cell.limits) == set(batch.limits)
    assert cell.params["warmup_jobs"] == 1 and cell.params["sample_every"] == 6
    assert len(cell.entry["why"]) <= 200


def test_metrics_of_the_cell():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    names = lambda trace: {m["name"] for m in cell_metrics(bench, "kdd99.mesh4", trace)}  # noqa
    assert names(False) == {"setup_s", "reduce_s", "peak_mem_GiB"}
    assert names(True) == {"device_idle_pct.reduce", *NEW_METRICS}
    for name in NEW_METRICS:
        m = next(m for m in bench["per_layer"] if m["name"] == name)
        assert m["moves"] == "reduce_s" and m["workloads"] == ["kdd99.mesh4"]


def test_the_count_by_hand():
    from plarbench.counts_mesh import (NVLINK_BYTES_PER_S, all_gather_received,
                                       all_reduce_received, nvlink_seconds)

    assert NVLINK_BYTES_PER_S == 450e9
    assert all_reduce_received(4.94e9) == 4.94e9
    assert all_gather_received(820e6, 4) == pytest.approx(615e6)
    assert nvlink_seconds(450e9) == 1.0


def test_the_new_modules_load_no_jax_and_nothing_of_the_program():
    names = _loaded(["plarbench.traffic.mesh", "plarbench.counts_mesh"])
    assert not names & {"jax", "jaxlib", "flax", "repro"}
    assert not _loaded(["plarbench.counts_mesh"], files="none") & {
        "jax", "jaxlib", "flax", "repro", "repro_torch"}


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


def _mesh_run(t, base, *, traced=False, spans=True):
    """Two jobs of one second at ``base`` and ``base + 2``: a 0.1 s
    ``mesh.granulate``, a 0.2 s ``mesh.core`` gathering 8e8 bytes over 4
    shards, a 0.6 s ``mesh.loop`` holding two 0.25 s iterations, one
    all-reducing 9e8 bytes and one ``fused`` of 1e6; 2e9 collective bytes a
    job.  Traced: one NCCL kernel of 0.1 s in each span."""
    jobs, ops = [], []
    for j in range(2):
        t0 = base + 2.0 * j
        if spans:
            t._record("mesh.granulate", "X", t0 + 0.01, 0.1, {"rows": 5, "granules": 3})
            t._record("mesh.core", "X", t0 + 0.12, 0.2,
                      {"gathered_bytes": 8e8, "n_data": 4, "n_attrs": 41, "core": 2})
            t._record("mesh.loop", "X", t0 + 0.33, 0.6, {"collective_bytes": 1.9e9})
            t._record("mesh.iteration", "X", t0 + 0.34, 0.25,
                      {"collective": "all_reduce", "bytes": 9e8})
            t._record("mesh.iteration", "X", t0 + 0.60, 0.25,
                      {"collective": "fused", "bytes": 1e6})
        ops += [t0 + 0.15, t0 + 0.40, t0 + 0.65]
        jobs.append({"j": j, "ok": True, "t0": t0, "t2": t0 + 1.0, "total_s": 1.0,
                     "collective_bytes": 2e9})
    tr = Trace(False, torch.device("cpu"))
    if traced:
        tr.ops = Ops(ops, [s + 0.1 for s in ops], [0] * len(ops),
                     ["ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage<4096ul>)"])
        tr._offset = 0.0
    return Run(cell=None, setup_s=0.0, window=(base - 1.0, base + 4.0), peak_window_bytes=1,
               record={"jobs": jobs}, trace=tr)


def test_readers_on_a_synthetic_run(tracer):
    from plarbench.counts_mesh import nvlink_seconds

    base = time.perf_counter() + 10.0
    run = _mesh_run(tracer, base)
    assert _reader("mesh_granulate_s.reduce").read(run) == pytest.approx(0.1)
    assert _reader("mesh_core_s.reduce").read(run) == pytest.approx(0.2)
    assert _reader("mesh_loop_s.reduce").read(run) == pytest.approx(0.6)
    assert _reader("collective_GB.reduce").read(run) == pytest.approx(2.0)
    assert _reader("collective_roofline_pct.reduce").read(run) is None    # the untraced half
    traced = _mesh_run(tracer, base + 10.0, traced=True)
    # the fused iteration's kernel and bytes are left out
    need = 2 * nvlink_seconds(0.75 * 8e8 + 9e8)
    assert _reader("collective_roofline_pct.reduce").read(traced) == pytest.approx(
        100.0 * need / 0.4)


def test_readers_read_nothing_where_the_program_has_no_such_span(tracer):
    base = time.perf_counter() + 10.0
    empty = _mesh_run(tracer, base, traced=True, spans=False)
    for name in NEW_METRICS:
        if name != "collective_GB.reduce":
            assert _reader(name).read(empty) is None
    for job in empty.record["jobs"]:
        del job["collective_bytes"]
    assert _reader("collective_GB.reduce").read(empty) is None
