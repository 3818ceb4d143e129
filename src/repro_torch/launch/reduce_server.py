"""Online reduct service demo of the PyTorch port (DESIGN.md §3.7/§3.9):

    python -m repro_torch.launch.reduce_server --dataset kdd99 --delta SCE
    python -m repro_torch.launch.reduce_server --dataset shuttle --updates 8 --json
    python -m repro_torch.launch.reduce_server --clients 8 --serial   # single-flight
    python -m repro_torch.launch.reduce_server --dataset shuttle --rows 4000 \
        --attrs 9 --updates 4 --device cpu

The flags of ``repro.launch.reduce_server``, plus ``--device {cuda,cpu}``
(default ``cuda``: no card is an error, never a silent CPU run).

Drives a paper dataset through :class:`repro_torch.service.ReductServer` as a live
stream: the first half of the table creates the dataset, the second half
arrives in ``--updates`` row batches, and the reduct is re-queried after
every batch.  Each query coalesces the pending batch, folds it into the
device-resident granularity (one monoid merge), and *repairs* the previous
reduct (warm-started selection) instead of recomputing it — the per-update
latency column against the from-scratch recompute at the end is the point
of the subsystem.  The final reduct is checked against a batch
``plar_reduce`` over the full table.

``--clients K`` adds K concurrent mixed-measure clients per round: their
queries land in one scheduler window and are served by stacked batched
dispatch (§3.9); the closing metrics block shows batch occupancy, dedup
hits, and sustained qps.  ``--serial`` runs the single-flight baseline
instead; ``--max-queue`` bounds admission.

Resilience (§3.10): ``--checkpoint-dir DIR`` makes the handle state
durable — run once, kill it, run again with the same DIR and the dataset
restores from the checkpoint (the first query is a warm repair, not a cold
rebuild).  ``--fault-plan SPEC`` injects deterministic failures (e.g.
``dispatch@1x2,merge@0``) which the retry/quarantine/stale layer absorbs;
the closing resilience line counts what fired.

Observability (§3.11): ``--metrics-port PORT`` serves the Prometheus text
exposition (process + server registries) on ``/metrics``;
``--stats-interval SECS`` prints a one-line registry snapshot to stderr
every interval; ``--trace-out PATH`` enables the flight recorder and
exports the Perfetto/Chrome-trace JSON on shutdown (open at
https://ui.perfetto.dev).
"""
from __future__ import annotations

import argparse
import asyncio
import json
import sys
import threading
import time


def _serve_metrics(port: int, registries):
    """The Prometheus exposition on a daemon thread; returns the server."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    from repro_torch import obs

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            body = obs.render_prometheus(extra=registries).encode()
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):  # stderr belongs to --stats-interval
            pass

    httpd = ThreadingHTTPServer(("", port), Handler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd


def _stats_reporter(interval: float, registries, stop: threading.Event):
    """One-line merged registry snapshot to stderr every ``interval`` s."""
    from repro_torch import obs

    def run():
        while not stop.wait(interval):
            snap = obs.get_registry().snapshot()
            for reg in registries:
                snap.update(reg.snapshot())
            print(f"[stats] {json.dumps(snap, sort_keys=True)}",
                  file=sys.stderr, flush=True)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.reduce_server")
    ap.add_argument("--dataset", default="kdd99")
    ap.add_argument("--delta", default="SCE", choices=["PR", "SCE", "LCE", "CCE"])
    ap.add_argument("--rows", type=int, default=20000,
                    help="row cap for the scaled dataset")
    ap.add_argument("--attrs", type=int, default=64, help="attribute cap")
    ap.add_argument("--updates", type=int, default=4,
                    help="update batches streaming in the second half")
    ap.add_argument("--clients", type=int, default=0,
                    help="extra concurrent mixed-measure clients per round "
                         "(exercises §3.9 batched dispatch)")
    ap.add_argument("--serial", action="store_true",
                    help="single-flight worker (the unbatched baseline)")
    ap.add_argument("--max-queue", type=int, default=1024,
                    help="admission-control queue depth")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="durable DatasetHandle checkpoints (§3.10): restore "
                         "on start, background save after merges, final "
                         "blocking save at stop")
    ap.add_argument("--fault-plan", default=None,
                    help="deterministic fault schedule, e.g. "
                         "'dispatch@1x2,merge@0,checkpoint@0' "
                         "(see repro_torch.service.faults)")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="serve the Prometheus text exposition (process + "
                         "server registries) on this port at /metrics")
    ap.add_argument("--stats-interval", type=float, default=None,
                    metavar="SECS",
                    help="print a one-line registry snapshot to stderr "
                         "every SECS seconds")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="enable flight-recorder tracing and export the "
                         "Perfetto/Chrome-trace JSON here on shutdown")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the datasets live and the reductions run "
                         "(default cuda; no card is an error)")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)

    from repro_torch import obs
    from repro_torch.core import plar_reduce
    from repro_torch.data import scaled_paper_dataset
    from repro_torch.device import resolve_device
    from repro_torch.service import FaultPlan, ReductServer, RetryPolicy

    resolve_device(args.device)   # fail before any work when no card is there

    if args.trace_out:
        obs.enable()

    stream = scaled_paper_dataset(args.dataset, max_rows=args.rows,
                                  max_attrs=args.attrs)
    x, d = stream.table()
    half = len(x) // 2
    rest = len(x) - half

    # K extra clients fan across the other measures (round-robin): a window
    # of mixed-measure queries per round, served by ONE stacked dispatch
    others = [m for m in ("PR", "SCE", "LCE", "CCE") if m != args.delta]
    client_measures = [others[i % len(others)] for i in range(args.clients)]

    fault_plan = FaultPlan.parse(args.fault_plan) if args.fault_plan else None

    server = ReductServer(batching=not args.serial,
                          max_queue=args.max_queue,
                          checkpoint_dir=args.checkpoint_dir,
                          fault_plan=fault_plan,
                          retry=RetryPolicy(),
                          serve_stale=fault_plan is not None,
                          device=args.device)

    httpd = None
    if args.metrics_port is not None:
        httpd = _serve_metrics(args.metrics_port, [server.registry])
        print(f"[metrics] http://localhost:{args.metrics_port}/metrics",
              file=sys.stderr, flush=True)
    stats_stop = threading.Event()
    if args.stats_interval:
        _stats_reporter(args.stats_interval, [server.registry], stats_stop)

    async def drive():
        async with server as srv:
            if "live" not in srv._handles:  # absent unless restored (§3.10)
                await srv.submit("live", x[:half], d[:half],
                                 n_dec=stream.n_dec, v_max=stream.v_max)
            events = []

            async def round_query(tag, rows):
                t0 = time.perf_counter()
                coros = [srv.query("live", delta=args.delta)]
                coros += [srv.query("live", delta=m) for m in client_measures]
                rs = await asyncio.gather(*coros)
                req = srv.requests[-1]
                granules = await asyncio.to_thread(
                    lambda: srv.handle("live").n_granules)
                events.append({
                    "event": tag, "rows": rows,
                    "granules": granules,
                    "reduct": rs[0].reduct,
                    "prefix_kept": req.prefix_kept,
                    "clients": 1 + len(client_measures),
                    "latency_s": round(time.perf_counter() - t0, 3)})
                return rs[0]

            r = await round_query("cold", half)
            for i in range(args.updates):
                lo = half + i * rest // args.updates
                hi = half + (i + 1) * rest // args.updates
                await srv.update("live", x[lo:hi], d[lo:hi])
                r = await round_query(f"update_{i + 1}", hi - lo)
            return r, events, dict(srv.stats), srv.metrics.summary()

    try:
        final, events, stats, metrics = asyncio.run(drive())
    finally:
        stats_stop.set()
        if httpd is not None:
            httpd.shutdown()
        if args.trace_out:
            tracer = obs.get_tracer()
            tracer.export(args.trace_out)
            print(f"[trace] {len(tracer.records())} spans -> "
                  f"{args.trace_out} (open at https://ui.perfetto.dev)",
                  file=sys.stderr, flush=True)

    # the from-scratch baseline the incremental path replaces
    t0 = time.perf_counter()
    batch = plar_reduce(x, d, delta=args.delta, n_dec=stream.n_dec,
                        v_max=stream.v_max, device=args.device)
    recompute_s = time.perf_counter() - t0
    warm_lat = [e["latency_s"] for e in events if e["event"] != "cold"]

    out = {
        "dataset": args.dataset, "delta": args.delta, "device": args.device,
        "table_shape": [len(x), x.shape[1]],
        "scheduler": "single-flight" if args.serial else "batched",
        "clients": 1 + len(client_measures),
        "events": events, "stats": stats, "metrics": metrics,
        "final_reduct": final.reduct,
        "batch_reduct": batch.reduct,
        "reduct_matches_batch": final.reduct == batch.reduct,
        "full_recompute_s": round(recompute_s, 3),
        "mean_update_latency_s": round(sum(warm_lat) / max(len(warm_lat), 1), 3),
    }
    if args.json:
        print(json.dumps(out, indent=2))
    else:
        for e in events:
            extra = (f"  prefix_kept={e['prefix_kept']}"
                     if "prefix_kept" in e else "")
            print(f"{e['event']:>10}: rows+{e['rows']:<7} "
                  f"granules={e['granules']:<6} {e['latency_s']:6.3f}s  "
                  f"reduct={e['reduct']}{extra}")
        print(f"\nfull recompute: {out['full_recompute_s']}s   "
              f"mean update latency: {out['mean_update_latency_s']}s")
        print(f"scheduler={out['scheduler']} clients={out['clients']}  "
              f"engine_runs={stats['engine_runs']} "
              f"dedup_hits={stats['dedup_hits']} "
              f"occupancy={metrics['mean_batch_occupancy']} "
              f"qps={metrics['qps_sustained']} "
              f"latency_p99={metrics['latency_p99_s']}s")
        if args.checkpoint_dir or args.fault_plan:
            print(f"resilience: restored={stats['restored_datasets']} "
                  f"checkpoints={stats['checkpoints']} "
                  f"retries={stats['retries']} "
                  f"quarantined={stats['quarantined']} "
                  f"stale_served={stats['stale_served']} "
                  f"flushed={stats['flushed_batches']}")
        print(f"final reduct matches batch plar_reduce: "
              f"{out['reduct_matches_batch']}")
    return out


if __name__ == "__main__":
    main()
