"""Chaos benchmark on the port: what failures cost with the recovery layer on
(the port of ``benchmarks/chaos_bench.py``).

    python -m repro_torch.launch.bench_chaos [--device cuda|cpu] [--section NAME]

* **refold vs rebuild** — losing 1 of S data shards costs re-folding that
  shard's lineage (``O(rows/S)``) plus one S-way re-merge; the naive answer
  is a full rebuild (``O(rows)``).  Both are timed on the same sharded
  build path, and the recovered granularity's fingerprint must equal the
  unfailed one's (bitwise parity).
* **restart warm vs cold** — restart-to-first-answer with a durable
  checkpoint (restored handles, a warm repair) against a cold process
  (rebuild and a cold greedy reduction); the answers must agree and the
  first query after the restart must be a warm repair (``warm == 1``).
* **fault storm** — the hardened server through transient dispatch faults,
  a merge fault and a checkpoint-write crash: every query answered, at
  least 3 faults fired and at least 2 retries.

The guarantees are asserted in the section functions; the wall-clock bound
(rebuild ≥ 1.5x the refold) is checked by the command line
(:mod:`.bench_common`).
"""
from __future__ import annotations

import asyncio
import tempfile
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.launch.bench_common import Bound, main as bench_main

__all__ = ["BOUNDS", "CHUNK_ROWS", "N_ATTRS", "N_ROWS", "N_SHARDS", "SECTIONS",
           "chaos_fault_storm_absorbed", "chaos_refold_vs_rebuild", "chaos_restart_warm_vs_cold"]

# Big enough that per-shard fold work dominates the fixed merge cost.
N_ROWS, N_ATTRS, N_SHARDS, CHUNK_ROWS = 120_000, 24, 8, 4096
BOUNDS = [Bound("chaos_refold_vs_rebuild", "rebuild_over_refold", ">=", 1.5)]


def _stream(n_rows: int = N_ROWS):
    from repro_torch.data.pipeline import TabularStream
    return TabularStream(n_rows=n_rows, n_attrs=N_ATTRS, v_max=3, n_dec=2,
                         distinct_fraction=0.05, seed=13)


def chaos_refold_vs_rebuild(*, device="cuda", n_rows: int = N_ROWS,
                            chunk_rows: int = CHUNK_ROWS) -> List[Dict]:
    from repro_torch.core.recovery import build_sharded, recover
    from repro_torch.service import granularity_fingerprint

    src = _stream(n_rows)
    # warm-up build: the fold and merge at these shapes once, not timed
    unfailed = build_sharded(src, N_SHARDS, chunk_rows=chunk_rows, device=device)
    fp = granularity_fingerprint(unfailed.merged)

    t0 = time.perf_counter()
    rebuilt = build_sharded(src, N_SHARDS, chunk_rows=chunk_rows, device=device)
    rebuild_s = time.perf_counter() - t0

    failed = build_sharded(src, N_SHARDS, chunk_rows=chunk_rows, device=device)
    failed.drop(N_SHARDS // 2)
    t0 = time.perf_counter()
    recovered = recover(failed, src)
    refold_s = time.perf_counter() - t0

    # parity first, speed second: recovery must be bitwise exact
    assert recovered == [N_SHARDS // 2]
    assert granularity_fingerprint(failed.merged) == fp
    assert granularity_fingerprint(rebuilt.merged) == fp
    return [{"rows": n_rows, "shards": N_SHARDS, "chunk_rows": chunk_rows,
             "refold_one_shard_s": refold_s, "full_rebuild_s": rebuild_s,
             "rebuild_over_refold": rebuild_s / max(refold_s, 1e-9), "parity": "bitwise"}]


def chaos_restart_warm_vs_cold(*, device="cuda", n_rows: int = 40_000) -> List[Dict]:
    from repro_torch.service import ReductServer

    src = _stream(max(n_rows, N_ROWS))
    x, d = src.chunk(0, n_rows)

    async def first_life(ckdir):
        async with ReductServer(checkpoint_dir=ckdir, device=device) as srv:
            await srv.submit("ds", x, d, n_dec=src.n_dec, v_max=src.v_max)
            await srv.query("ds", delta="SCE")
            # persist the warm fixed point (what the restart repairs from)
            return await asyncio.to_thread(srv.handle("ds").reduce, "SCE")

    async def restart(ckdir):
        t0 = time.perf_counter()
        async with ReductServer(checkpoint_dir=ckdir, device=device) as srv:
            r = await srv.query("ds", delta="SCE")
            return r, time.perf_counter() - t0, dict(srv.stats)

    async def cold_process():
        t0 = time.perf_counter()
        async with ReductServer(device=device) as srv:
            await srv.submit("ds", x, d, n_dec=src.n_dec, v_max=src.v_max)
            r = await srv.query("ds", delta="SCE")
            return r, time.perf_counter() - t0

    with tempfile.TemporaryDirectory() as ckdir:
        r0 = asyncio.run(first_life(ckdir))
        warm_r, warm_s, stats = asyncio.run(restart(ckdir))
        cold_r, cold_s = asyncio.run(cold_process())

    assert stats["restored_datasets"] == 1
    assert stats["warm"] == 1, "first post-restart query must repair, not rebuild"
    assert warm_r.reduct == r0.reduct, "restart changed the answer"
    assert sorted(warm_r.reduct) == sorted(cold_r.reduct)
    return [{"rows": len(x), "measure": "SCE", "restart_warm_first_answer_s": warm_s,
             "cold_first_answer_s": cold_s, "cold_over_warm": cold_s / max(warm_s, 1e-9),
             "restored": stats["restored_datasets"], "parity": "reduct"}]


def chaos_fault_storm_absorbed(*, device="cuda", n_rows: int = 20_000) -> List[Dict]:
    """Transient dispatch faults, a merge fault and a checkpoint crash, all
    absorbed: every query answered, no client-visible error."""
    from repro_torch.service import FaultPlan, ReductServer, RetryPolicy

    rng = np.random.default_rng(17)
    x = rng.integers(0, 3, (n_rows, 16)).astype(np.int32)
    d = rng.integers(0, 2, (n_rows,)).astype(np.int32)
    plan = FaultPlan.parse("dispatch@1,dispatch@3,merge@1,checkpoint@1")
    half, step = n_rows // 2, n_rows // 8

    async def drive(ckdir):
        async with ReductServer(checkpoint_dir=ckdir, fault_plan=plan,
                                retry=RetryPolicy(base_delay_s=0.001), serve_stale=True,
                                device=device) as srv:
            await srv.submit("ds", x[:half], d[:half], n_dec=2, v_max=3)
            answered = 0
            for i in range(4):
                lo = half + i * step
                await srv.update("ds", x[lo:lo + step], d[lo:lo + step])
                r = await srv.query("ds", delta="PR")
                answered += bool(r.reduct is not None)
            return answered, dict(srv.stats), srv.checkpointer.failed_saves

    with tempfile.TemporaryDirectory() as ckdir:
        answered, stats, failed_saves = asyncio.run(drive(ckdir))

    faults_fired = len(plan.fired)
    assert answered == 4, "a fault leaked to a client"
    assert faults_fired >= 3, f"plan under-fired: {plan.fired}"
    assert stats["retries"] >= 2
    return [{"queries": 4, "answered": answered, "faults_fired": faults_fired,
             "retries": stats["retries"], "stale_served": stats["stale_served"],
             "checkpoint_write_failures": failed_saves, "client_errors": 0}]


SECTIONS = {
    "chaos_refold_vs_rebuild": chaos_refold_vs_rebuild,
    "chaos_restart_warm_vs_cold": chaos_restart_warm_vs_cold,
    "chaos_fault_storm_absorbed": chaos_fault_storm_absorbed,
}


def main(argv: Optional[Sequence[str]] = None):
    return bench_main("bench_chaos", SECTIONS, BOUNDS, argv)


if __name__ == "__main__":
    main()
