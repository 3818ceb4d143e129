"""The spans inside the port's reduction and reduct service
(``repro_torch.obs``), and the counted host reads they carry.

* ``Tracer.epoch`` ties every record to ``time.perf_counter()``;
* one ``plar_reduce`` on the host loop records ``reduce.granulate``,
  ``reduce.plar``, ``reduce.theta_full``, ``reduce.core`` (when the core is
  computed), ``reduce.greedy`` and one ``reduce.iteration`` an iteration,
  nested as the calls are, with ``host_reads`` equal to the counted reads;
* the warm repair says what it kept and whether it ran again;
* the service's spans of one update share its ``epoch``;
* a disabled recorder records nothing, and no attribute costs a read, on or
  off; tile resolution records nothing and looks nothing up per launch.
"""
import asyncio
import json
import time

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.core import plar_reduce
from repro_torch.core.granularity import fold_chunk
from repro_torch.core.reduction import resolve_granularity
from repro_torch.device import host_reads
from repro_torch.kernels.contingency import autotune
from repro_torch.service import ReductServer, repair_reduce

torch.set_num_threads(1)
CPU = "cpu"
REDUCE = ("reduce.granulate", "reduce.plar", "reduce.theta_full", "reduce.core",
          "reduce.greedy", "reduce.iteration")


@pytest.fixture
def tracer():
    """The process recorder, cleared and on for the test, then as it was."""
    t = obs.get_tracer()
    was = t.enabled
    t.clear()
    t.enable()
    yield t
    t.clear()
    t.enabled = was


def _table(seed=5, n=600, a=9, vmax=3, m=3):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, vmax, size=(n, a)).astype(np.int32)
    x[:, 4] = x[:, 1]                      # a redundant copy
    d = ((x[:, 0] + x[:, 2]) % m).astype(np.int32)
    d[rng.random(n) < 0.05] = 0            # some noise, so the core is not everything
    return x, d


def _spans(tracer, names):
    return [r for r in tracer.records() if r.ph == "X" and r.name in names]


def _inside(inner, outer) -> bool:
    return outer.t_start <= inner.t_start and inner.t_start + inner.dur <= outer.t_start + outer.dur


def test_tracer_epoch_ties_records_to_perf_counter(tmp_path):
    t = obs.Tracer(enabled=True)
    before = time.perf_counter()
    t.event("clock")
    after = time.perf_counter()
    rec = t.records()[-1]
    assert before <= t.epoch + rec.t_start <= after
    with pytest.raises(AttributeError):
        t.epoch = 0.0
    epoch = t.epoch
    t.clear()
    assert t.epoch == epoch                                  # a clear keeps the clock
    doc = json.loads(open(t.export(str(tmp_path / "t.json"))).read())
    assert doc["otherData"]["perf_counter_epoch_s"] == t.epoch


@pytest.mark.parametrize("delta,core", [("SCE", True), ("PR", False)])
def test_span_tree_of_one_reduction(tracer, delta, core):
    x, d = _table()
    r0 = host_reads()
    gran = resolve_granularity(x, d, device=CPU)
    r = plar_reduce(source=gran, delta=delta, backend="sweep", compute_core=core, device=CPU)
    reads = host_reads() - r0
    recs = _spans(tracer, REDUCE)
    by = {n: [s for s in recs if s.name == n] for n in REDUCE}
    assert [len(by[n]) for n in REDUCE] == [2, 1, 1, int(core), 1, r.iterations]
    outer, (plar,), (greedy,) = by["reduce.granulate"][0], by["reduce.plar"], by["reduce.greedy"]
    assert outer.t_start + outer.dur <= plar.t_start          # the job's two calls, in order
    for s in by["reduce.granulate"][1:] + by["reduce.theta_full"] + by["reduce.core"] + [greedy]:
        assert _inside(s, plar)
    assert all(_inside(s, greedy) for s in by["reduce.iteration"])
    assert outer.args["host_reads"] + plar.args["host_reads"] == reads > 0
    assert outer.args["granules"] == int(gran.num) and outer.args["rows"] == len(x)
    assert plar.args["iterations"] == r.iterations
    assert plar.args["evaluations"] == r.n_evaluations
    assert (plar.args["delta"], plar.args["backend"], plar.args["engine"]) == (
        delta, "sweep", "host")
    assert plar.args["launches"] == 0                       # the CPU runs the plain versions
    assert greedy.args["forced"] == len(r.core)
    if core:
        assert by["reduce.core"][0].args == {"n_attrs": x.shape[1], "core": len(r.core),
                                             "host_reads": 1}
    its = [s.args for s in by["reduce.iteration"]]
    assert [a["i"] for a in its] == list(range(r.iterations))
    assert all(a["chunks"] == 1 and a["k"] >= 1 for a in its)
    assert [a["candidates"] for a in its] == list(
        range(x.shape[1] - len(r.core), x.shape[1] - len(r.core) - r.iterations, -1))


def test_repair_span_says_what_it_kept_and_ran_again(tracer):
    x, d = _table(seed=8)
    gran = resolve_granularity(x, d, device=CPU)
    cold = plar_reduce(source=gran, delta="PR", backend="sweep", device=CPU)
    extra = next(a for a in range(x.shape[1]) if a not in cold.reduct)
    stale = cold.reduct + [extra]          # past the stopping target: trimmed, run again
    for prev, reruns in ((cold.reduct, 0), (stale, 1)):
        tracer.clear()
        r, kept = repair_reduce(gran, prev, delta="PR", backend="sweep")
        (rep,) = _spans(tracer, ("service.repair",))
        assert rep.args == {"prev": len(prev), "kept": kept, "reruns": reruns}
        assert len(_spans(tracer, ("reduce.plar",))) == 1 + reruns
        assert r.reduct == cold.reduct
    assert kept == len(cold.reduct) < len(stale)


def test_service_spans_of_one_update_share_its_epoch(tracer):
    x, d = _table(seed=3, n=900)

    async def drive():
        async with ReductServer(device=CPU) as srv:
            await srv.submit("t", x[:300], d[:300], n_dec=3, v_max=3)
            await srv.query("t", "PR", backend="sweep")
            tracer.clear()
            await srv.update("t", x[300:600], d[300:600])
            return await srv.query("t", "PR", backend="sweep")

    asyncio.run(drive())
    spans = {r.name: r for r in tracer.records() if r.ph == "X"}
    assert spans["server.update"].args == {"dataset": "t", "epoch": 1}
    for name in ("scheduler.coalesce", "scheduler.merge", "scheduler.dispatch"):
        assert spans[name].args["epoch"] == 1, name
    disp = spans["scheduler.dispatch"].args
    assert disp["warm"] is True and disp["prefix_kept"] == spans["service.repair"].args["kept"]
    assert spans["scheduler.coalesce"].t_start + spans["scheduler.coalesce"].dur <= (
        spans["scheduler.merge"].t_start)
    validates = [r for r in tracer.records() if r.name == "service.validate"]
    assert [v.args["rows"] for v in validates] == [300, 300]   # the server's, then the merge's
    assert "service.fingerprint" in spans


def _count_tensor_reads(monkeypatch):
    """Every conversion of a tensor to a host value, counted."""
    calls = []
    for name in ("__int__", "__float__", "__bool__", "__index__", "item", "tolist", "cpu"):
        orig = getattr(torch.Tensor, name)

        def counted(self, *a, _orig=orig, **k):
            calls.append(1)
            return _orig(self, *a, **k)
        monkeypatch.setattr(torch.Tensor, name, counted)
    return calls


def test_a_disabled_recorder_records_nothing_and_attributes_cost_no_reads(monkeypatch):
    """On or off, the streaming fold converts no tensor to a host value but
    through the counted reads (its span's ``granules`` reuses one), and a
    whole reduction makes the same conversions either way."""
    x, d = _table(seed=11)
    t = obs.get_tracer()
    was = t.enabled
    runs = {}
    try:
        for on in (False, True):
            t.clear()
            t.enabled = on
            calls = _count_tensor_reads(monkeypatch)
            r0 = host_reads()
            acc = fold_chunk(None, x[:300], d[:300], n_dec=3, v_max=3, device=CPU)
            acc = fold_chunk(acc, x[300:], d[300:], n_dec=3, v_max=3, device=CPU)
            fold = (len(calls), host_reads() - r0)
            r = plar_reduce(source=acc, delta="SCE", backend="sweep", device=CPU)
            runs[on] = (fold, len(calls), host_reads() - r0, r.reduct, t.recorded)
            monkeypatch.undo()
    finally:
        t.clear()
        t.enabled = was
    (fold_calls, fold_reads), *_ = runs[False]
    assert fold_calls == fold_reads > 0
    assert runs[False][:4] == runs[True][:4]
    assert runs[False][4] == 0 and runs[True][4] > 0


def test_tile_resolution_records_nothing_and_looks_nothing_up(tracer, monkeypatch, tmp_path):
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(tmp_path / "autotune.json"))
    monkeypatch.setattr(autotune, "_disk_state", {"path": None, "data": None})

    def refuse(*a, **k):
        raise AssertionError("resolve_tiles went to the recorder or the registry")
    monkeypatch.setattr(obs, "event", refuse)
    monkeypatch.setattr(obs, "counter", refuse)
    misses = autotune._DISK_MISSES.value
    for selector in ("pinned", "heuristic", "analytic"):
        autotune.resolve_tiles("sweep", nc=4, g=300, n_bins=64, m=3, v_max=4,
                               selector=selector)
    assert tracer.recorded == 0
    assert autotune._DISK_MISSES.value == misses + 1
    registry = obs.get_registry()
    assert registry.counter("plar_autotune_disk_misses_total") is autotune._DISK_MISSES
