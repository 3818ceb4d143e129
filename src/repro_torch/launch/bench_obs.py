"""Observability benchmark on the port: tracer overhead and the traced chaos
run (the port of ``benchmarks/obs_bench.py``).

    python -m repro_torch.launch.bench_obs [--device cuda|cpu] [--section NAME]

* ``obs_tracer_overhead`` — the zero-overhead-when-disabled contract: the
  per-span cost with :mod:`repro_torch.obs`'s tracer disabled and enabled,
  then the serve firehose (:mod:`.bench_serve`) driven both ways.  The
  disabled-mode overhead, spans a query x the disabled span's cost over the
  firehose's mean per-query latency, must stay below 2%: the command
  line's bound (:mod:`.bench_common`), as the JAX benchmark asserts it.
* ``obs_trace_chaos`` — a sharded build loses a shard and recovers through
  lineage, a fault plan fails a dispatch mid-serve, checkpoints land, with
  the flight recorder on: the exported Perfetto JSON must hold spans of
  the engine, the scheduler, the checkpoint and the recovery, every event
  in the Chrome-trace schema, and a flight-recorder dump must lie beside
  the checkpoints.  Asserted in the section function.
"""
from __future__ import annotations

import asyncio
import glob
import json
import os
import tempfile
import time
from typing import Dict, List, Optional, Sequence

from repro_torch.launch import bench_serve
from repro_torch.launch.bench_common import Bound, main as bench_main

__all__ = ["BOUNDS", "OVERHEAD_CEILING", "SECTIONS", "SPAN_LOOP", "obs_trace_chaos",
           "obs_tracer_overhead"]

SPAN_LOOP = 200_000          # disabled spans are nanoseconds each: a long loop steadies it
OVERHEAD_CEILING = 0.02      # the disabled tracer's share of a firehose query
BOUNDS = [Bound("obs_tracer_overhead", "overhead_frac", "<", OVERHEAD_CEILING)]


def _span_cost_s(enabled: bool, loops: int) -> float:
    """Per-span wall cost of ``with obs.span(...): pass`` (no attrs)."""
    from repro_torch import obs

    tracer = obs.get_tracer()
    was = tracer.enabled
    (tracer.enable if enabled else tracer.disable)()
    try:
        t0 = time.perf_counter()
        for _ in range(loops):
            with obs.span("bench.noop"):
                pass
        dt = time.perf_counter() - t0
    finally:
        tracer.enabled = was
    return dt / loops


def obs_tracer_overhead(*, device="cuda", n_rows: int = bench_serve.N_ROWS,
                        rounds: int = bench_serve.ROUNDS,
                        loops: int = SPAN_LOOP) -> List[Dict]:
    from repro_torch import obs

    tracer = obs.get_tracer()
    disabled_s = _span_cost_s(False, loops)
    enabled_s = _span_cost_s(True, loops)
    tables, chunks = bench_serve.make_firehose(n_rows, rounds)
    n_queries = rounds * len(bench_serve.CLIENTS)

    def firehose():
        return bench_serve.run_workload(True, tables, chunks, device=device, rounds=rounds)

    tracer.disable()
    _, span_off, _, _ = firehose()
    tracer.enable()
    tracer.clear()
    recorded_before = tracer.recorded
    try:
        _, span_on, _, _ = firehose()
        spans_recorded = tracer.recorded - recorded_before
    finally:
        tracer.disable()

    # the deterministic bound: what the disabled tracer costs the firehose
    spans_per_query = spans_recorded / n_queries
    per_query_s = span_off / n_queries
    overhead_frac = spans_per_query * disabled_s / per_query_s
    assert spans_recorded > 0, "the enabled tracer recorded no span of the firehose"
    return [
        {"probe": "span_disabled", "ns_per_span": disabled_s * 1e9,
         "spans_per_s": 1.0 / disabled_s, "firehose_s": span_off},
        {"probe": "span_enabled", "ns_per_span": enabled_s * 1e9,
         "spans_per_s": 1.0 / enabled_s, "firehose_s": span_on,
         "spans_per_query": spans_per_query},
        {"probe": "disabled_overhead_bound", "spans_per_query": spans_per_query,
         "per_query_s": per_query_s, "overhead_frac": overhead_frac,
         "overhead_pct": overhead_frac * 100},
    ]


def obs_trace_chaos(*, device="cuda", n_rows: int = 6000,
                    chunk_rows: int = 2048) -> List[Dict]:
    """The chaos run, flight-recorded end to end."""
    from repro_torch import obs
    from repro_torch.core.recovery import build_sharded, recover
    from repro_torch.data.pipeline import TabularStream
    from repro_torch.service import FaultPlan, ReductServer, RetryPolicy

    stream = TabularStream(n_rows=n_rows, n_attrs=16, v_max=3, n_dec=2, relevance=3, seed=5)
    tracer = obs.enable()
    tracer.clear()
    try:
        with tempfile.TemporaryDirectory() as ckdir:
            # shard 1 dies after the build; the lineage refold recovers it
            plan = FaultPlan.parse("shard_drop@0:1,dispatch@0")
            build = build_sharded(stream, 4, chunk_rows=chunk_rows, fault_plan=plan,
                                  device=device)
            assert build.lost == [1]
            recovered = recover(build, stream)

            async def drive():
                async with ReductServer(checkpoint_dir=ckdir, fault_plan=plan,
                                        retry=RetryPolicy(), serve_stale=True,
                                        device=device) as srv:
                    x, d = stream.table()
                    half = len(x) // 2
                    await srv.submit("live", x[:half], d[:half], n_dec=stream.n_dec,
                                     v_max=stream.v_max)
                    r1 = await srv.query("live", "SCE")   # dispatch@0 fires
                    await srv.update("live", x[half:], d[half:])
                    r2 = await srv.query("live", "SCE")   # merge + checkpoint
                    return r1, r2, dict(srv.stats)

            _r1, _r2, stats = asyncio.run(drive())
            assert stats["retries"] >= 1, stats   # the dispatch fault fired
            assert stats["checkpoints"] >= 1, stats

            # the fault firing must have dumped the flight recorder
            dumps = glob.glob(os.path.join(ckdir, "flightrec-*.json"))
            assert dumps, f"no flight-recorder dump in {ckdir}"
            with open(dumps[0]) as f:
                assert json.load(f)["traceEvents"], "empty flight-recorder dump"

            trace_path = os.path.join(ckdir, "chaos_trace.json")
            tracer.export(trace_path)
            with open(trace_path) as f:
                doc = json.load(f)

        events = doc["traceEvents"]
        for ev in events:   # Chrome-trace schema, every event
            assert {"name", "cat", "ph", "ts", "pid", "tid"} <= set(ev)
            assert ev["ph"] in ("X", "i")
            assert (ev["ph"] != "X") or "dur" in ev
        cats = {ev["cat"] for ev in events}
        need = {"engine", "scheduler", "checkpoint", "recovery"}
        assert need <= cats, f"missing subsystems: {need - cats} (got {cats})"
        by_cat = {c: sum(ev["cat"] == c for ev in events) for c in sorted(cats)}
        return [{"check": "chaos_trace", "events": len(events), "subsystems": len(cats),
                 "by_cat": by_cat, "recovered_shards": len(recovered), "dumps": len(dumps),
                 "ok": True}]
    finally:
        obs.disable()
        obs.set_dump_dir(None)


SECTIONS = {
    "obs_tracer_overhead": obs_tracer_overhead,
    "obs_trace_chaos": obs_trace_chaos,
}


def main(argv: Optional[Sequence[str]] = None):
    return bench_main("bench_obs", SECTIONS, BOUNDS, argv)


if __name__ == "__main__":
    main()
