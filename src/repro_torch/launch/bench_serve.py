"""Multi-tenant serving benchmark on the port: batched dispatch vs
single-flight (the port of ``benchmarks/serve_bench.py``).

    python -m repro_torch.launch.bench_serve [--device cuda|cpu] [--section NAME]

N concurrent clients with mixed measures over M datasets, under a
streaming-update firehose (every round lands one update batch per dataset,
then all clients query at once).  The batched scheduler of
:class:`~repro_torch.service.ReductServer` coalesces each dataset's window
into one stacked dispatch; the single-flight baseline serves the same
workload one engine run a query.  The JAX benchmark's constants and
sections, with its guarantees asserted in the section functions:

* **parity** — every batched result is byte-identical (reduct, Θ history,
  Θ_full) to its single-flight twin from the same round;
* **dedup** — C identical concurrent queries make exactly 1 engine run;
* **admission** — submits above the bounded queue depth fail fast with
  ``ServerOverloaded``, and the server serves again after the drain.

The wall-clock bound (batched ≥ 2.0x single-flight queries a second) is
checked by the command line (:mod:`.bench_common`), not by the sections.
"""
from __future__ import annotations

import asyncio
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.launch.bench_common import Bound, main as bench_main

__all__ = ["BOUNDS", "CLIENTS", "N_ATTRS", "N_LATENT", "N_ROWS", "ROUNDS", "SECTIONS",
           "V_MAX", "latent_table", "make_firehose", "run_workload",
           "serve_batched_vs_single_flight", "serve_dedup_and_admission"]

# 8-client mixed-measure workload over 2 datasets: each dataset's window
# carries all four measures → one stacked C=4 dispatch per dataset per
# round, on the dispatch-bound tier shape (few latent factors → small
# granularity, so each engine run is mostly fixed dispatch cost).
N_ROWS, N_ATTRS, N_LATENT, V_MAX = 20000, 32, 4, 3
CLIENTS = [(ds, m) for ds in ("A", "B") for m in ("PR", "SCE", "LCE", "CCE")]
ROUNDS = 3
BOUNDS = [Bound("serve_batched_vs_single_flight", "speedup", ">=", 2.0)]


def latent_table(n: int, a: int, n_latent: int, vmax: int, seed: int):
    """Columns are relabelings of a few latent factors → small |U/A| after
    GrC init, non-trivial reducts (≈ one attribute per informative factor).
    The JAX benchmarks' ``engine_bench._latent_table``, draw for draw."""
    rng = np.random.default_rng(seed)
    z = rng.integers(0, vmax, size=(n, n_latent)).astype(np.int32)
    cols = []
    for _ in range(a):
        src = rng.integers(0, n_latent)
        perm = rng.permutation(vmax).astype(np.int32)
        cols.append(perm[z[:, src]])
    x = np.stack(cols, axis=1)
    d = (z.sum(1) % 2).astype(np.int32)
    return x, d


def make_firehose(n_rows: int = N_ROWS, rounds: int = ROUNDS):
    """The two datasets' halves and their ``rounds + 1`` update batches."""
    tables, chunks = {}, {}
    for i, name in enumerate(("A", "B")):
        x, d = latent_table(n_rows, N_ATTRS, N_LATENT, V_MAX, seed=41 + i)
        base = n_rows // 2
        tables[name] = (x, d, base)
        step = (n_rows - base) // (rounds + 1)     # one batch feeds the warm-up round
        chunks[name] = [(x[base + r * step: base + (r + 1) * step],
                         d[base + r * step: base + (r + 1) * step])
                        for r in range(rounds + 1)]
    return tables, chunks


def run_workload(batching: bool, tables, chunks, *, device="cuda", rounds: int = ROUNDS,
                 clients: Sequence = CLIENTS):
    """Drive the firehose; returns (per-round results, timed span, stats,
    metrics summary)."""
    from repro_torch.service import ReductServer

    async def drive():
        async with ReductServer(batching=batching, device=device) as srv:
            for name, (x, d, base) in tables.items():
                await srv.submit(name, x[:base], d[:base], n_dec=2, v_max=V_MAX)
            # warm-up round: cold and warm paths once, not timed
            await asyncio.gather(*[srv.query(ds, m) for ds, m in clients])
            for name in tables:
                await srv.update(name, *chunks[name][0])
            await asyncio.gather(*[srv.query(ds, m) for ds, m in clients])

            per_round = []
            t0 = time.perf_counter()
            for r in range(1, rounds + 1):
                for name in tables:   # the firehose: one batch per dataset
                    await srv.update(name, *chunks[name][r])
                per_round.append(await asyncio.gather(*[srv.query(ds, m) for ds, m in clients]))
            span = time.perf_counter() - t0
            return per_round, span, dict(srv.stats), srv.metrics.summary()

    return asyncio.run(drive())


def serve_batched_vs_single_flight(*, device="cuda", n_rows: int = N_ROWS,
                                   rounds: int = ROUNDS) -> List[Dict]:
    tables, chunks = make_firehose(n_rows, rounds)
    b_rounds, b_span, b_stats, b_metrics = run_workload(True, tables, chunks, device=device,
                                                        rounds=rounds)
    s_rounds, s_span, s_stats, s_metrics = run_workload(False, tables, chunks, device=device,
                                                        rounds=rounds)

    # parity: every batched result byte-identical to its single-flight twin
    for r, (brs, srs) in enumerate(zip(b_rounds, s_rounds)):
        for (ds, m), rb, rs_ in zip(CLIENTS, brs, srs):
            assert rb.reduct == rs_.reduct, f"round {r} {ds}/{m}: reduct diverged"
            assert np.array_equal(np.asarray(rb.theta_history),
                                  np.asarray(rs_.theta_history)), \
                f"round {r} {ds}/{m}: theta history diverged"
            assert rb.theta_full == rs_.theta_full, f"round {r} {ds}/{m}: theta_full diverged"

    n_queries = rounds * len(CLIENTS)
    speedup = (n_queries / b_span) / max(n_queries / s_span, 1e-9)

    def _row(mode, span, stats, metrics):
        return {"mode": mode, "clients": len(CLIENTS), "datasets": len(tables),
                "rounds": rounds, "queries": n_queries, "span_s": span,
                "qps": n_queries / span, "engine_runs": stats["engine_runs"],
                "mean_occupancy": metrics["mean_batch_occupancy"],
                "latency_p50_s": metrics["latency_p50_s"],
                "latency_p99_s": metrics["latency_p99_s"]}

    return [_row("batched", b_span, b_stats, b_metrics),
            _row("single_flight", s_span, s_stats, s_metrics),
            {"mode": "speedup", "speedup": speedup, "parity": "ok"}]


def serve_dedup_and_admission(*, device="cuda", n_rows: int = 8000) -> List[Dict]:
    """In-flight dedup and admission control, counted exactly."""
    from repro_torch.service import ReductServer, ServerOverloaded

    x, d = latent_table(n_rows, 24, 4, V_MAX, seed=7)

    async def drive():
        rows = []
        # C identical concurrent queries → exactly 1 engine dispatch
        async with ReductServer(device=device) as srv:
            await srv.submit("s", x, d, n_dec=2, v_max=V_MAX)
            c = 6
            rs = await asyncio.gather(*[srv.query("s", "SCE", tol=1e-6) for _ in range(c)])
            assert srv.stats["engine_runs"] == 1, srv.stats
            assert srv.stats["dedup_hits"] == c - 1
            assert all(r is rs[0] for r in rs)
            rows.append({"check": "inflight_dedup", "clients": c,
                         "engine_runs": srv.stats["engine_runs"],
                         "dedup_hits": srv.stats["dedup_hits"], "rejected": 0,
                         "recovered": "-"})
        # over-capacity submits fail fast, then the server recovers
        async with ReductServer(max_queue=3, device=device) as srv:
            await srv.submit("s", x, d, n_dec=2, v_max=V_MAX)
            tasks = [asyncio.create_task(srv.query("s", "PR", max_features=i + 1))
                     for i in range(6)]
            done = await asyncio.gather(*tasks, return_exceptions=True)
            rejected = sum(isinstance(r, ServerOverloaded) for r in done)
            served = sum(not isinstance(r, Exception) for r in done)
            assert rejected >= 1 and served >= 1
            assert served + rejected == len(tasks)
            r = await srv.query("s", "SCE")   # backlog drained: admits again
            assert r.reduct is not None
            rows.append({"check": "admission_control", "clients": len(tasks),
                         "engine_runs": srv.stats["engine_runs"],
                         "dedup_hits": srv.stats["dedup_hits"], "rejected": rejected,
                         "recovered": True})
        return rows

    return asyncio.run(drive())


SECTIONS = {
    "serve_batched_vs_single_flight": serve_batched_vs_single_flight,
    "serve_dedup_and_admission": serve_dedup_and_admission,
}


def main(argv: Optional[Sequence[str]] = None):
    return bench_main("bench_serve", SECTIONS, BOUNDS, argv)


if __name__ == "__main__":
    main()
