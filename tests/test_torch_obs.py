"""The port's observability layer (``repro_torch.obs``, DESIGN.md §3.11):
flight-recorder tracing, the metrics registry, and their contracts.

Mirrors ``tests/test_obs.py`` on the port's own copy of the JAX package's
``obs`` (the port imports nothing of the JAX package), with the port's
``FaultPlan`` and ``ServiceMetrics``.

The acceptance surface: a disabled tracer costs *nothing* (singleton no-op
span, zero net allocations in the hot path); an enabled one records into a
bounded ring that exports valid Perfetto/Chrome-trace JSON; a fired fault
plan dumps the recorder next to the checkpoints; and the registry re-base
of ``ServiceMetrics`` keeps ``summary()`` byte-compatible with the plain
dict counters it replaced.
"""
import json
import threading
import tracemalloc

import pytest

from repro_torch import obs
from repro_torch.obs import trace as trace_mod
from repro_torch.obs.registry import (
    Counter,
    CounterMap,
    Gauge,
    Histogram,
    MetricsRegistry,
    sanitize,
)
from repro_torch.service import FaultPlan
from repro_torch.service.metrics import RequestTiming, ServiceMetrics


@pytest.fixture(autouse=True)
def _clean_tracer_state():
    """Every test starts disabled with no dump dir and leaves no residue."""
    tracer = obs.get_tracer()
    was_enabled = tracer.enabled
    was_dir = trace_mod._dump_state["dir"]
    tracer.disable()
    yield
    tracer.clear()
    tracer.enabled = was_enabled
    obs.set_dump_dir(was_dir)


# ---------------------------------------------------------------------------
# tracer: spans, ring, threads
# ---------------------------------------------------------------------------

def test_span_nesting_records_inner_first():
    t = obs.Tracer(enabled=True)
    with t.span("scheduler.window", requests=2):
        with t.span("engine.dispatch", n_attrs=8) as sp:
            sp.set(k=3, compiled=True)
    recs = t.records()
    # inner span closes (and records) before the outer one
    assert [r.name for r in recs] == ["engine.dispatch", "scheduler.window"]
    inner, outer = recs
    assert inner.cat == "engine" and outer.cat == "scheduler"
    assert inner.args == {"n_attrs": 8, "k": 3, "compiled": True}
    assert outer.args == {"requests": 2}
    assert inner.ph == outer.ph == "X"
    assert inner.dur >= 0.0
    # nesting is by interval containment (how Perfetto reconstructs stacks)
    assert outer.t_start <= inner.t_start
    assert inner.t_start + inner.dur <= outer.t_start + outer.dur + 1e-9


def test_span_records_exception_and_propagates():
    t = obs.Tracer(enabled=True)
    with pytest.raises(ValueError):
        with t.span("checkpoint.write"):
            raise ValueError("disk on fire")
    (rec,) = t.records()
    assert rec.args["error"] == "ValueError"


def test_event_is_instant():
    t = obs.Tracer(enabled=True)
    t.event("scheduler.retry", site="dispatch", attempt=1)
    (rec,) = t.records()
    assert rec.ph == "i" and rec.dur == 0.0
    assert rec.cat == "scheduler"


def test_ring_is_bounded_keeps_newest():
    t = obs.Tracer(capacity=8, enabled=True)
    for i in range(20):
        t.event("x.e", i=i)
    assert len(t) == 8
    assert t.recorded == 20
    assert t.dropped == 12
    assert [r.args["i"] for r in t.records()] == list(range(12, 20))
    assert [r.args["i"] for r in t.records(last_n=3)] == [17, 18, 19]


def test_tracer_thread_safety():
    t = obs.Tracer(capacity=100_000, enabled=True)
    n_threads, per = 8, 500
    gate = threading.Barrier(n_threads)   # all alive at once → distinct tids

    def work():
        gate.wait()
        for _ in range(per):
            with t.span("pipeline.fold_chunk"):
                pass

    threads = [threading.Thread(target=work) for _ in range(n_threads)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert t.recorded == n_threads * per
    assert len(t) == n_threads * per
    assert len({r.tid for r in t.records()}) == n_threads


def test_enable_resize_preserves_tail():
    t = obs.Tracer(capacity=16, enabled=True)
    for i in range(10):
        t.event("x.e", i=i)
    t.enable(capacity=4)
    assert t.capacity == 4
    assert [r.args["i"] for r in t.records()] == [6, 7, 8, 9]


# ---------------------------------------------------------------------------
# the zero-overhead-when-disabled contract
# ---------------------------------------------------------------------------

def test_disabled_span_is_the_singleton():
    assert not obs.get_tracer().enabled
    s = obs.span("engine.dispatch")
    assert s is obs.span("scheduler.window")
    assert s is trace_mod._NULL_SPAN
    # full live-span surface, still a no-op
    with s as inner:
        assert inner.set(k=1) is s
    assert obs.get_tracer().recorded == 0
    obs.event("x.y")        # also a no-op
    assert obs.get_tracer().recorded == 0


def test_disabled_span_allocates_nothing():
    # no-kwargs call sites (what the hot paths use) must not allocate:
    # the null span is a process singleton and event() returns early
    for _ in range(1000):            # warm-up: interned frames, caches
        with obs.span("bench.noop"):
            pass
        obs.event("bench.noop")
    tracemalloc.start()
    try:
        snap1 = tracemalloc.take_snapshot()
        for _ in range(10_000):
            with obs.span("bench.noop"):
                pass
            obs.event("bench.noop")
        snap2 = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    # nothing attributable to the tracing module may grow with the call
    # count: 10k disabled spans must leave only the O(1) snapshot-time
    # residue (the last call's transient **kwargs dict on a free list),
    # never per-call retained objects
    leaks = [s for s in snap2.compare_to(snap1, "filename")
             if s.traceback[0].filename == trace_mod.__file__
             and s.size_diff > 0]
    assert sum(s.count_diff for s in leaks) <= 8, leaks
    assert sum(s.size_diff for s in leaks) < 1024, leaks


# ---------------------------------------------------------------------------
# Perfetto export + dump-on-failure
# ---------------------------------------------------------------------------

def test_export_writes_valid_chrome_trace(tmp_path):
    import numpy as np

    t = obs.Tracer(enabled=True)
    with t.span("engine.dispatch", n_attrs=np.int64(16), tiles=(8, 128)):
        pass
    t.event("faults.fired", kind="dispatch")
    out = t.export(str(tmp_path / "trace.json"), meta={"run": "unit"})
    assert out == str(tmp_path / "trace.json")
    with open(out) as f:
        doc = json.load(f)
    assert set(doc) == {"traceEvents", "displayTimeUnit", "otherData"}
    assert doc["displayTimeUnit"] == "ms"
    assert doc["otherData"]["recorded"] == 2
    assert doc["otherData"]["dropped"] == 0
    assert doc["otherData"]["run"] == "unit"
    span_ev, inst_ev = doc["traceEvents"]
    assert span_ev["ph"] == "X" and "dur" in span_ev
    assert inst_ev["ph"] == "i" and inst_ev["s"] == "t"
    for ev in doc["traceEvents"]:
        assert {"name", "cat", "ph", "ts", "pid", "tid"} <= set(ev)
    # numpy scalar collapsed via item(), tuple went through repr()
    assert span_ev["args"]["n_attrs"] == 16
    assert span_ev["args"]["tiles"] == "(8, 128)"


def test_request_dump_noop_unless_armed(tmp_path):
    assert obs.request_dump("why") is None          # no dir, disabled
    obs.set_dump_dir(str(tmp_path))
    assert obs.request_dump("why") is None          # dir set, still disabled
    obs.enable()
    obs.event("x.y")
    path = obs.request_dump("why not/here", meta={"step": 3})
    assert path is not None
    with open(path) as f:
        doc = json.load(f)
    assert doc["otherData"]["reason"] == "why not/here"
    assert doc["otherData"]["step"] == 3
    assert "/" not in path.rsplit("flightrec-", 1)[1]   # reason sanitized


def test_fault_plan_firing_dumps_flight_recorder(tmp_path):
    obs.enable()
    obs.set_dump_dir(str(tmp_path))
    plan = FaultPlan.parse("dispatch@1")
    assert plan.fire("dispatch") is None            # step 0: nothing fires
    assert not list(tmp_path.glob("flightrec-*.json"))
    spec = plan.fire("dispatch")                    # step 1: scheduled fault
    assert spec is not None and spec.transient
    dumps = list(tmp_path.glob("flightrec-*.json"))
    assert len(dumps) == 1
    doc = json.loads(dumps[0].read_text())
    assert doc["otherData"]["kind"] == "dispatch"
    assert doc["otherData"]["step"] == 1
    # the firing itself is on the recorded timeline
    assert any(ev["name"] == "faults.fired" for ev in doc["traceEvents"])


def test_dump_gc_keeps_newest(tmp_path):
    obs.enable()
    obs.set_dump_dir(str(tmp_path))
    paths = [obs.request_dump("storm") for _ in range(trace_mod._MAX_DUMPS + 5)]
    assert all(p is not None for p in paths)
    left = sorted(f.name for f in tmp_path.glob("flightrec-*.json"))
    assert len(left) == trace_mod._MAX_DUMPS
    assert left[-1] == paths[-1].rsplit("/", 1)[1]  # newest survived


# ---------------------------------------------------------------------------
# registry: instruments + exposition
# ---------------------------------------------------------------------------

def test_counter_is_monotonic():
    reg = MetricsRegistry()
    c = reg.counter("plar_x_total", "help text")
    c.inc()
    c.inc(4)
    assert c.value == 5
    c.set(7)
    assert c.value == 7
    with pytest.raises(ValueError):
        c.inc(-1)
    with pytest.raises(ValueError):
        c.set(3)
    assert reg.counter("plar_x_total") is c         # get-or-create


def test_gauge_and_histogram():
    reg = MetricsRegistry()
    g = reg.gauge("plar_last_k")
    g.set(12)
    g.inc(-2)
    assert g.value == 10
    h = reg.histogram("plar_lat_seconds", buckets=(0.01, 0.1, 1.0))
    for v in (0.005, 0.05, 0.5, 5.0):
        h.observe(v)
    assert h.count == 4 and h.sum == pytest.approx(5.555)
    cum = h.cumulative()
    assert cum == [("0.01", 1), ("0.1", 2), ("1", 3), ("+Inf", 4)]
    snap = reg.snapshot()
    assert snap["plar_last_k"] == 10
    assert snap["plar_lat_seconds_count"] == 4
    assert snap["plar_lat_seconds_sum"] == pytest.approx(5.555)


def test_registry_kind_clash_raises():
    reg = MetricsRegistry()
    reg.counter("plar_thing")
    with pytest.raises(ValueError, match="already registered"):
        reg.gauge("plar_thing")


def test_sanitize_names():
    assert sanitize("plar_ok_total") == "plar_ok_total"
    assert sanitize("bad name-1") == "bad_name_1"
    assert sanitize("0starts_bad") == "_0starts_bad"


def test_prometheus_exposition_format():
    reg = MetricsRegistry()
    reg.counter("plar_runs_total", "engine runs").inc(3)
    reg.gauge("plar_k").set(4)
    h = reg.histogram("plar_s", buckets=(0.5, 1.0))
    h.observe(0.25)
    h.observe(2.0)
    text = reg.render_prometheus()
    lines = text.splitlines()
    assert "# HELP plar_runs_total engine runs" in lines
    assert "# TYPE plar_runs_total counter" in lines
    assert "plar_runs_total 3" in lines
    assert "# TYPE plar_k gauge" in lines
    assert "plar_k 4" in lines
    assert "# TYPE plar_s histogram" in lines
    assert 'plar_s_bucket{le="0.5"} 1' in lines
    assert 'plar_s_bucket{le="1"} 1' in lines
    assert 'plar_s_bucket{le="+Inf"} 2' in lines
    assert "plar_s_sum 2.25" in lines
    assert "plar_s_count 2" in lines
    assert text.endswith("\n")
    # the merged view reduce_server --metrics-port serves
    merged = obs.render_prometheus(extra=[reg])
    assert "plar_runs_total 3" in merged.splitlines()


def test_counter_map_keeps_dict_semantics():
    reg = MetricsRegistry()
    m = CounterMap(reg, prefix="plar_srv_", initial=("queries", "merges"))
    assert dict(m) == {"queries": 0, "merges": 0}    # insertion-ordered
    m["queries"] += 1
    m["queries"] += 2
    assert m["queries"] == 3
    assert m.get("queries") == 3
    assert m.get("never", 0) == 0
    assert "never" not in m                          # .get did not register
    m["late"] += 1                                   # defaultdict(int) read
    assert list(m) == ["queries", "merges", "late"]
    assert len(m) == 3
    snap = m.copy()                                  # dict.copy() surface
    assert snap == {"queries": 3, "merges": 0, "late": 1}
    assert isinstance(snap, dict)
    with pytest.raises(TypeError):
        del m["queries"]
    with pytest.raises(ValueError):
        m["queries"] = 1                             # counters can't decrease
    # the same bumps are visible on the registry under the prefix
    assert reg.snapshot()["plar_srv_queries"] == 3


# ---------------------------------------------------------------------------
# ServiceMetrics re-base: summary() byte-compatibility
# ---------------------------------------------------------------------------

def test_service_metrics_summary_byte_compat():
    m = ServiceMetrics()
    for wait, total in ((0.001, 0.004), (0.002, 0.01)):
        t = RequestTiming(t_enqueue=0.0, t_start=wait, t_done=total)
        m.observe(t)
    m.observe_dispatch(3)
    m.inc("dedup_hits")
    m.inc("engine_runs", 2)                          # a caller-added counter
    s = m.summary()
    assert list(s) == [
        "completed", "engine_dispatches", "batched_queries", "dedup_hits",
        "rejected", "qps_sustained", "mean_batch_occupancy",
        "queue_wait_p50_s", "queue_wait_p99_s", "latency_p50_s",
        "latency_p99_s", "engine_runs",
    ]
    assert s["completed"] == 2
    assert s["engine_dispatches"] == 1
    assert s["batched_queries"] == 3
    assert s["dedup_hits"] == 1
    assert s["rejected"] == 0
    assert s["mean_batch_occupancy"] == 3.0
    assert s["latency_p50_s"] == pytest.approx(0.007)
    assert s["engine_runs"] == 2
    # the registry view carries the identical numbers
    snap = m.registry.snapshot()
    assert snap["plar_service_completed"] == 2
    assert snap["plar_service_latency_seconds_count"] == 2
    assert snap["plar_service_last_batch_occupancy"] == 3
