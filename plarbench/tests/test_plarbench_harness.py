"""The harness on the CPU at a test's size: cells, mixes, drivers and metrics
found by name; ``correct`` false under each fault a cell can have."""
import hashlib
import json
from pathlib import Path

import pytest

from plarbench.harness import cell_metrics, find_cell, run_cell
from plarbench.tests._tiny import make_tree

QUIET = dict(seconds=0.5, trace=False, device="cpu", log=lambda msg: None)


def _run(root: Path, name: str, **kwargs):
    return run_cell(root, find_cell(root, name), **kwargs)


@pytest.fixture(autouse=True)
def _jax_loaded_elsewhere(monkeypatch):
    """Other test files of this process load JAX and the JAX package to hold
    the port against them; a real run's process is checked by
    ``test_plarbench_imports.py`` in a subprocess of its own."""
    from plarbench import harness

    monkeypatch.setattr(harness, "forbidden_modules", lambda: [])


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return make_tree(tmp_path_factory.mktemp("bench"))


def _digest(root: Path) -> dict:
    return {p.relative_to(root).as_posix(): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_metric_selection():
    bench = json.loads((Path(__file__).resolve().parents[2] / "BENCHMARK.json").read_text())
    names = lambda cell, trace: [m["name"] for m in cell_metrics(bench, cell, trace)]  # noqa: E731
    assert names("kdd99.batch", False) == ["setup_s", "reduce_s", "peak_mem_GiB"]
    assert names("kdd99.stream", False) == ["setup_s", "update_p50_s", "update_p95_s",
                                            "peak_mem_GiB"]
    assert "theta_roofline_pct.reduce" in names("sdss.batch", True)
    assert "merge_s.update" not in names("sdss.batch", True)


@pytest.mark.parametrize("cell", ["tiny.batch", "tiny.stream"])
def test_cells_run_and_are_correct(tree, cell):
    r = _run(tree, cell, seed=2**33 + 3, **QUIET)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert set(r["metrics"]) >= {"setup_s"}
    assert list(r)[-1] == "checks"


def test_a_cell_a_mix_a_driver_and_a_metric_added_as_files(tmp_path):
    root = make_tree(tmp_path)
    before = _digest(root)
    base = root / "plarbench"
    (base / "configs" / "tiny2.json").write_text(json.dumps(
        {**json.loads((base / "configs" / "tiny.json").read_text()), "name": "tiny2",
         "attrs": 8}))
    (base / "traffic" / "twice.json").write_text(json.dumps(
        {"driver": "twice", "params": {"warmup_jobs": 1, "sample_every": 1, "chunk": 8}}))
    (base / "traffic" / "twice.py").write_text(
        "from plarbench.traffic import batch\n"
        "setup, release, check = batch.setup, batch.release, batch.check\n"
        "def window(ctx, st, seconds):\n"
        "    return batch.window(ctx, st, seconds / 2)\n")
    (base / "workloads" / "tiny2.twice.json").write_text(json.dumps(
        {"config": "tiny2", "traffic": "twice", "why": "added by files",
         "params": {}, "limits": {"reduct_off": 0, "theta_gap": 1e-6},
         "theta_reach": {"exact": 1e-6, "rounded": 4e-6}}))
    (base / "metrics" / "jobs_n.twice.py").write_text(
        "def read(run):\n    return len(run.record['jobs'])\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny2", "source": "test", "reduced": [],
                             "file": "plarbench/configs/tiny2.json", "why": "test"})
    bench["workloads"].append({"name": "tiny2.twice", "config": "tiny2", "traffic": "twice",
                               "chips": 1, "why": "test"})
    bench["end_to_end"][0].setdefault("workloads", [])
    bench["end_to_end"][0]["workloads"] = ["tiny2.twice"]
    bench["per_layer"].append({"name": "jobs_n.twice", "unit": "jobs", "better": "higher",
                               "source": "host_clock", "layer": "test", "moves": "setup_s",
                               "workloads": ["tiny2.twice"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = find_cell(root, "tiny2.twice")
    assert cell.config["attrs"] == 8 and cell.params["sample_every"] == 1
    r = _run(root, "tiny2.twice", seed=17, **QUIET)
    assert r["correct"] and set(r["metrics"]) == {"setup_s"}
    traced = _run(root, "tiny2.twice", seed=18, **{**QUIET, "trace": True})
    assert traced["metrics"]["jobs_n.twice"]["value"] >= 1
    after = _digest(root)
    assert all(after[k] == v for k, v in before.items() if k != "BENCHMARK.json")


def _stale_step(monkeypatch):
    from repro_torch.core import reduction

    inner = reduction._advance

    def advance(cfg, coll, r, *args, **kwargs):
        _ids, k, theta, pure = inner(cfg, coll, r, *args, **kwargs)
        return r, k, theta, pure                  # the step returns its state unchanged
    monkeypatch.setattr(reduction, "_advance", advance)


def _half_rows(monkeypatch):
    from repro_torch.core import reduction

    inner = reduction.resolve_granularity

    def resolve(x=None, d=None, **kwargs):
        if x is not None:
            x, d = x[: len(x) // 2], d[: len(d) // 2]   # half the batch left out
        return inner(x, d, **kwargs)
    monkeypatch.setattr(reduction, "resolve_granularity", resolve)


def _altered(monkeypatch):
    from repro_torch.core import reduction

    inner = reduction.plar_reduce

    def reduce(*args, **kwargs):
        r = inner(*args, **kwargs)
        swap = next(a for a in range(64) if a not in r.reduct)
        r.reduct = r.reduct[:-1] + [swap]             # an answer altered where it is made
        return r
    monkeypatch.setattr(reduction, "plar_reduce", reduce)


def _update_ignored(monkeypatch):
    from repro_torch.service.state import DatasetHandle

    monkeypatch.setattr(DatasetHandle, "update", lambda self, x, d: None)


def _update_half(monkeypatch):
    from repro_torch.service.state import DatasetHandle

    inner = DatasetHandle.update
    monkeypatch.setattr(DatasetHandle, "update",
                        lambda self, x, d: inner(self, x[: len(x) // 2], d[: len(d) // 2]))


def _reply_altered(monkeypatch):
    from repro_torch.service.state import DatasetHandle

    inner = DatasetHandle.reduce

    def reduce(self, *args, **kwargs):
        r = inner(self, *args, **kwargs)
        swap = next(a for a in range(64) if a not in r.reduct)
        r.reduct = r.reduct[:-1] + [swap]             # the reply altered where it is made
        return r
    monkeypatch.setattr(DatasetHandle, "reduce", reduce)


@pytest.mark.parametrize("cell,fault", [
    ("tiny.batch", _stale_step), ("tiny.batch", _half_rows), ("tiny.batch", _altered),
    ("tiny.stream", _update_ignored), ("tiny.stream", _update_half),
    ("tiny.stream", _reply_altered),
])
def test_faults_come_out_not_correct(tree, monkeypatch, cell, fault):
    fault(monkeypatch)
    r = _run(tree, cell, seed=2**33 + 4, **QUIET)
    assert r is not None and r["correct"] is False, r["checks"]


class _FakeEvent:
    def __init__(self, name, start_s, dur_s):
        self._n, self._s, self._d = name, int(start_s * 1e9), int(dur_s * 1e9)

    def device_type(self):
        import torch
        return torch.autograd.DeviceType.CUDA

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d


def _fake_profiler(monkeypatch):
    """The card's profiler, faked on the CPU: a 1 ms kernel every 2 ms
    (every other one a Θ kernel), and the marks at their host times + 100 s."""
    import time
    import types

    import torch

    from plarbench import harness, profiling

    marks = []

    class Prof:
        def __init__(self, activities):
            pass

        def start(self):
            self.t0 = time.perf_counter()

        def stop(self):
            t, evs, i = self.t0, [], 0
            while t < time.perf_counter():
                evs.append(_FakeEvent("void repro::short_tiles_kernel<int>(int const*)" if i % 2
                                      else "elementwise_kernel", 100.0 + t, 1e-3))
                t, i = t + 2e-3, i + 1
            evs += [_FakeEvent("at::cuda::(anonymous namespace)::spin_kernel(long)",
                               100.0 + m + 5e-6, 1e-6) for m in marks]
            self.profiler = types.SimpleNamespace(
                kineto_results=types.SimpleNamespace(events=lambda: evs))

    class Traced(profiling.Trace):
        def __init__(self, enabled, device):
            super().__init__(enabled, torch.device("cuda"))

    monkeypatch.setattr(torch.profiler, "profile", Prof)
    monkeypatch.setattr(torch.cuda, "_sleep", lambda cycles: marks.append(time.perf_counter()))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(harness, "Trace", Traced)


@pytest.mark.parametrize("cell,metrics", [
    ("tiny.batch", {"granulate_s.reduce", "loop_s.reduce", "theta_roofline_pct.reduce",
                    "device_idle_pct.reduce"}),
    ("tiny.stream", {"merge_s.update", "dispatch_s.update", "device_idle_pct.update"}),
])
def test_a_traced_run_reads_its_metrics(tree, monkeypatch, cell, metrics):
    _fake_profiler(monkeypatch)
    r = _run(tree, cell, seed=5, **{**QUIET, "trace": True})
    assert r["correct"] and set(r["metrics"]) == metrics
    for name in metrics:
        if name.startswith("device_idle_pct"):
            assert 40 < r["metrics"][name]["value"] < 60        # half of every 2 ms busy
    assert 0 < r["device"]["busy_s"] < r["device"]["window_s"]
    assert r["breakdown"]["device_ops"][0][1] > 0 and r["breakdown"]["idle_gaps"]


def test_a_traced_run_reads_the_host_clock_without_the_profiler(tmp_path, monkeypatch):
    """Host-clock metrics read the untraced half of a traced run's window,
    device-trace metrics the profiled half; the two halves make the run."""
    root = make_tree(tmp_path)
    reader = ("def read(run):\n"
              "    assert run.trace.traced == {traced}\n"
              "    return len(run.record['jobs'])\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for name, source, traced in [("jobs_host.reduce", "host_clock", False),
                                 ("jobs_device.reduce", "device_trace", True)]:
        (root / "plarbench" / "metrics" / f"{name}.py").write_text(reader.format(traced=traced))
        bench["per_layer"].append({"name": name, "unit": "jobs", "better": "higher",
                                   "source": source, "layer": "test", "moves": "reduce_s",
                                   "workloads": ["tiny.batch"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    _fake_profiler(monkeypatch)
    r = _run(root, "tiny.batch", seed=7, **{**QUIET, "trace": True})
    host, device = (r["metrics"][f"jobs_{h}.reduce"]["value"] for h in ("host", "device"))
    assert r["correct"] and host >= 1 and device >= 1
    assert host + device == r["attempted"]


def test_a_stream_cell_runs_at_its_fixed_rate_only(tree):
    cell = find_cell(tree, "tiny.stream")
    assert cell.params["rate_per_s"] > 0
    cell.params["rate_per_s"] = None
    with pytest.raises(TypeError):
        run_cell(tree, cell, seed=3, **QUIET)
