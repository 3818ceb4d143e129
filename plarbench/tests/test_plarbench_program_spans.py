"""The readers of the program's spans (``plarbench/program_spans.py``, the
metrics that read it) on synthetic runs, the span tool's arithmetic, and the
stream driver's clock against ``Tracer.epoch``."""
import json
import time
import types
from pathlib import Path

import pytest
import torch

from plarbench.harness import Context, Run, find_cell, load_module
from plarbench.profiling import Ops, Trace
from plarbench.tests._tiny import make_tree

REPO = Path(__file__).resolve().parents[2]
NEW = ("theta_full_s.reduce", "core_s.reduce", "greedy_s.reduce", "host_reads.reduce",
       "greedy_idle_pct.reduce")


@pytest.fixture
def tracer():
    """The program's recorder, cleared, as ``program_spans`` leaves it (on);
    afterwards as it was."""
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


def _span(t, name, start, dur, **args):
    t._record(name, "X", start, dur, args or None)


def _jobs_run(t, base, traced=False, peak=1):
    """Two jobs of one second at ``base`` and ``base + 2``: granulate 0.2 s,
    then plar with Θ(D|C) 0.1, core 0.3 and greedy 0.3 s (two iterations)."""
    jobs = []
    for j in range(2):
        t0 = base + 2.0 * j
        _span(t, "reduce.granulate", t0, 0.2, host_reads=3)
        _span(t, "reduce.granulate", t0 + 0.25, 0.01, host_reads=1)
        _span(t, "reduce.theta_full", t0 + 0.3, 0.1)
        _span(t, "reduce.core", t0 + 0.4, 0.3)
        _span(t, "reduce.iteration", t0 + 0.7, 0.1)
        _span(t, "reduce.iteration", t0 + 0.85, 0.1)
        _span(t, "reduce.greedy", t0 + 0.7, 0.3)
        _span(t, "reduce.plar", t0 + 0.2, 0.8, host_reads=40 + j)
        jobs.append({"j": j, "ok": True, "t0": t0, "t2": t0 + 1.0})
    jobs.append({"j": 2, "ok": False})
    tr = Trace(False, torch.device("cpu"))
    if traced:       # the device busy for the first half of every greedy span
        starts = [base + 2.0 * j + 0.7 for j in range(2)]
        tr.ops = Ops(starts, [s + 0.15 for s in starts], [0, 0], ["k"])
        tr._offset = 0.0
    return Run(cell=None, setup_s=0.0, window=(base - 1.0, base + 4.0),
               peak_window_bytes=peak, record={"jobs": jobs}, trace=tr)


def test_readers_on_a_synthetic_run(tracer):
    base = time.perf_counter() + 10.0
    run = _jobs_run(tracer, base)
    got = {n: _reader(n).read(run) for n in NEW}
    assert got["theta_full_s.reduce"] == pytest.approx(0.1)
    assert got["core_s.reduce"] == pytest.approx(0.3)
    assert got["greedy_s.reduce"] == pytest.approx(0.3)
    assert got["host_reads.reduce"] == pytest.approx((3 + 40 + 3 + 41) / 2)
    assert got["greedy_idle_pct.reduce"] is None          # the untraced half
    traced = _jobs_run(tracer, base + 10.0, traced=True)
    assert _reader("greedy_idle_pct.reduce").read(traced) == pytest.approx(50.0)


def test_readers_read_nothing_off_the_card_or_without_spans(tracer):
    base = time.perf_counter() + 10.0
    off = _jobs_run(tracer, base, traced=True, peak=None)
    assert all(_reader(n).read(off) is None for n in NEW)
    tracer.clear()
    empty = _jobs_run(types.SimpleNamespace(_record=lambda *a: None), base, traced=True)
    assert all(_reader(n).read(empty) is None for n in NEW)


def test_a_lost_record_gives_no_number(tracer):
    base = time.perf_counter() + 10.0
    run = _jobs_run(tracer, base)
    tracer.dropped = 1                       # the ring lost records, but none of the half's
    _span(tracer, "reduce.plar", base - 5.0, 0.1)
    tracer._buf.appendleft(tracer._buf.pop())
    assert _reader("theta_full_s.reduce").read(run) == pytest.approx(0.1)
    tracer._buf.popleft()                    # now the oldest kept record is inside the half
    assert all(_reader(n).read(run) is None for n in NEW)


def test_outermost_keeps_the_spans_that_hold_the_others():
    from plarbench.program_spans import Span, outermost

    s = [Span("b", 1.0, 2.0, {}), Span("a", 0.0, 0.5, {}), Span("c", 1.2, 1.5, {}),
         Span("d", 1.0, 1.1, {})]
    assert [x.name for x in outermost(s)] == ["a", "b"]


def test_span_tool_arithmetic():
    from plarbench.tools.span_gaps import summarize
    from repro_torch.obs import Tracer

    t = Tracer(enabled=True)
    e = t.epoch
    t._record("reduce.plar", "X", e + 1.0, 2.0, {"host_reads": 5})
    t._record("reduce.iteration", "X", e + 1.5, 1.0, {"i": 0})
    t._record("scheduler.window", "X", e + 0.0, 4.0, None)
    t._record("reduce.plar", "X", e + 9.0, 0.5, None)          # outside every unit
    tr = Trace(False, torch.device("cpu"))
    tr.ops = Ops([1.0, 2.2], [1.5, 3.0], [0, 1], ["a", "b"])   # the iteration ends inside "b"
    tr._offset = -e                           # device time 0 is the recorder's epoch
    out = summarize(tr, t.records(), e, [(e + 0.0, e + 4.0)],
                    phases=[("loop", e + 0.0, e + 4.0)],
                    driver_spans=[("reduce.plar", e + 1.0 + 2e-6, e + 3.0)],
                    marks_after={e + 3.0: 3.0 + 1e-5,     # device idle 10 us before it
                                 e + 2.5: 3.0 + 1e-6})    # queued behind "b"
    assert out["units"] == 1 and out["outside_share"] == pytest.approx(0.5)
    plar, it = out["spans"]["reduce.plar"], out["spans"]["reduce.iteration"]
    assert plar["count"] == 1 and plar["seconds"] == pytest.approx(2.0)
    assert plar["idle_share"] == pytest.approx(1.0 - 1.3 / 2.0)
    assert plar["ends_in_op_share"] == 0.0 and it["ends_in_op_share"] == 1.0
    assert plar["idle_after_end_s"] == pytest.approx(1e-5)
    assert plar["ends_in_op_share_by_clock"] == 0.0 and it["ends_in_op_share_by_clock"] == 1.0
    assert plar["max_args"] == {"host_reads": 5}
    assert out["idle_gaps"][0] == ["loop", pytest.approx(1.0)]      # before the first op
    assert ["reduce.iteration", pytest.approx(0.7)] in out["idle_gaps"]
    assert out["epoch_gap_s"] == pytest.approx(2e-6)
    assert out["records_a_unit"] == 3


def test_the_stream_driver_clock_agrees_with_the_epoch(tmp_path):
    """The stream driver places its spans on the host clock by a dummy
    event; ``Tracer.epoch`` gives the same times.  The service's new spans
    cover the updates' time but for the event loop's own steps."""
    from plarbench.tools.span_gaps import summarize
    from repro_torch import obs

    root = make_tree(tmp_path)
    cell = find_cell(root, "tiny.stream")
    tr = Trace(True, torch.device("cuda"))     # enabled: the driver records its spans
    ctx = Context(cell=cell, seed=2**33 + 9, device=torch.device("cpu"), trace=tr,
                  log=lambda msg: None)
    t = obs.get_tracer()
    was = t.enabled
    st = cell.driver.setup(ctx)
    try:
        record = cell.driver.window(ctx, st, 1.0)
    finally:
        cell.driver.release(ctx, st)
        t.enabled = was
    assert record["spans"] and record["failed"] == 0
    units = [(u["start"], u["done"]) for u in record["updates"]]
    out = summarize(Trace(False, torch.device("cpu")), t.records(), t.epoch, units,
                    driver_spans=record["spans"])
    t.clear()
    assert out["epoch_gap_s"] < 1e-3
    spans = out["spans"]
    n = len(units)
    assert spans["server.update"]["count"] == n and spans["scheduler.coalesce"]["count"] == n
    assert spans["service.validate"]["count"] == 2 * n
    assert spans["service.repair"]["count"] == n
    assert spans["scheduler.dispatch"]["max_args"]["warm"] is True
    assert 0.0 <= out["outside_share"] < 1.0
    json.dumps(out, default=repr)


def test_the_span_tool_ties_the_clocks_on_the_least_lag():
    """The harness's tie pairs the marks around the first one's lag (on the
    card the window's first mark lagged most); the tool's takes the least."""
    from plarbench.profiling import _tie_clocks
    from plarbench.tools.span_gaps import _tie_on_every_mark

    hosts = [0.0, 1.0, 2.0, 3.0, 4.0, 5.0]
    lags = [4.5e-3, 1e-5, 4.6e-3, 4.4e-3, 2e-5, 4.5e-3]
    devs = [100.0 + h + lag for h, lag in zip(hosts, lags)]
    found = {}
    assert _tie_on_every_mark(found)(devs, hosts) == pytest.approx(100.0 + 1e-5)
    assert found["harness"] - found["least"] == pytest.approx(4.39e-3)
    assert found["mark_lag_max_s"] == pytest.approx(4.59e-3)
    lost = {}                                 # a mark lost: the harness's tie, as it is
    assert _tie_on_every_mark(lost)(devs[1:], hosts) == _tie_clocks(devs[1:], hosts)
    assert "least" not in lost
    mine = {}                                 # the harness's tie leaves the tool's marks out
    _tie_on_every_mark(mine, own={1.0, 4.0})(devs, hosts)
    assert mine["harness"] == pytest.approx(100.0 + 4.4e-3)
    assert mine["least"] == pytest.approx(100.0 + 1e-5)


def test_the_span_tool_reads_idle_through_both_ties():
    """Beside the idle share through its own tie, the tool reads it through
    the harness's, which places host times ``harness_late_s`` later."""
    from plarbench.tools.span_gaps import summarize
    from repro_torch.obs import Tracer

    t = Tracer(enabled=True)
    e = t.epoch
    t._record("reduce.greedy", "X", e + 1.0, 1.0, None)
    tr = Trace(False, torch.device("cpu"))
    tr.ops = Ops([1.0], [1.5], [0], ["a"])
    tr._offset = -e
    greedy = summarize(tr, t.records(), e, [(e + 0.0, e + 4.0)],
                       harness_late_s=0.25)["spans"]["reduce.greedy"]
    assert greedy["idle_share"] == pytest.approx(0.5)
    assert greedy["idle_share_harness_tie"] == pytest.approx(0.75)   # [1.25, 2.25] on the device
    assert "idle_share_harness_tie" not in summarize(
        tr, t.records(), e, [(e + 0.0, e + 4.0)])["spans"]["reduce.greedy"]


def test_the_span_tool_control_runs_without_a_cell(capsys, monkeypatch):
    """``--control`` records its two span kinds, and the tool refuses a run
    that names both a cell and the control, or neither."""
    from plarbench import profiling
    from plarbench.tools.span_gaps import main
    from repro_torch import obs

    t = obs.get_tracer()
    was = t.enabled
    monkeypatch.setattr(profiling, "_tie_clocks", profiling._tie_clocks)  # the tool swaps it
    try:
        main(["--control", "2", "--seed", str(2**33 + 5), "--device", "cpu"])
    finally:
        t.__dict__.pop("_record", None)                                    # and wraps this
        t.enabled = was
        t.clear()
    out = json.loads(capsys.readouterr().out)
    assert out["workload"] == "control" and out["units"] == 1
    assert out["spans"]["control.queued"]["count"] == 2
    assert out["spans"]["control.read"]["count"] == 2
    for argv in (["--seed", "1"], ["--workload", "kdd99.batch", "--control", "2", "--seed", "1"]):
        with pytest.raises(SystemExit):
            main(argv)
