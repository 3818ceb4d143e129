"""The port's resilience layer (DESIGN.md §3.10) on the CPU: lineage
recovery, durable checkpoints, fault injection and the hardened serving
path, held against the JAX package's.

Mirrors ``tests/test_recovery.py``: a build that loses a shard and
recovers it by re-folding ONLY that shard's lineage is **bitwise
identical** to the unfailed build — granularity arrays, fingerprint, and
downstream reducts and Θ histories across ≥3 measures; a killed-and-
restarted server restores its handles from the checkpoint and answers its
first query warm.  Added here: the port's sharded build, re-fold and merge
equal the JAX package's live prefix element for element; a checkpoint
written by either package's ``ServiceCheckpointer`` restores in the other
with equal fingerprints, reducts and Θ histories (the on-disk layout is
shared, key for key).
"""
import asyncio
import json
import os

import numpy as np
import pytest
import torch

from repro.core.recovery import build_sharded as j_build_sharded
from repro.core.recovery import merge_shards as j_merge_shards
from repro.data import TabularStream as JStream
from repro.service import DatasetHandle as JHandle
from repro.service import ServiceCheckpointer as JCheckpointer
from repro.service import granularity_fingerprint as j_fingerprint
from repro_torch.core import plar_reduce
from repro_torch.core.recovery import (
    ChunkSlice,
    ShardLineage,
    build_sharded,
    merge_shards,
    recover,
    refold_shard,
)
from repro_torch.data import TabularStream
from repro_torch.service import (
    CheckpointCorrupt,
    DatasetHandle,
    FaultInjected,
    FaultPlan,
    FaultSpec,
    QueryPoisoned,
    ReductServer,
    RetryPolicy,
    ServerStopped,
    ServiceCheckpointer,
    ShardLost,
    granularity_fingerprint,
    repair_reduce,
)
from repro_torch.train.checkpoint import CheckpointManager

# The tensors here are tiny: PyTorch's intra-op thread pool only adds
# overhead, and across pytest-xdist workers it oversubscribes the cores.
torch.set_num_threads(1)

PARITY_DELTAS = ["PR", "SCE", "LCE"]
CPU = "cpu"


def _stream(n=900, a=8, seed=0, cls=TabularStream):
    return cls(n_rows=n, n_attrs=a, v_max=3, n_dec=2, distinct_fraction=0.3, seed=seed)


def _np(t):
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _fingerprint(g):
    return (granularity_fingerprint if isinstance(g.x, torch.Tensor) else j_fingerprint)(g)


def _gran_equal(g1, g2):
    """Bitwise equality of the live prefix + static metadata (either package)."""
    n1, n2 = int(g1.num), int(g2.num)
    assert n1 == n2
    for k in ("x", "d", "w"):
        np.testing.assert_array_equal(_np(getattr(g1, k))[:n1], _np(getattr(g2, k))[:n1])
    assert int(g1.n_total) == int(g2.n_total)
    assert _fingerprint(g1) == _fingerprint(g2)


def _same_reduction(a, b):
    assert a.reduct == b.reduct
    assert a.core == b.core
    assert a.theta_history == b.theta_history
    assert a.theta_full == b.theta_full


# ---------------------------------------------------------------------------
# shard lineage + re-fold recovery
# ---------------------------------------------------------------------------


def test_refold_shard_bitwise_identical():
    """Replaying one shard's lineage reproduces its granularity exactly."""
    src = _stream()
    build = build_sharded(src, 4, chunk_rows=256, device=CPU)
    assert build.n_shards == 4 and not build.lost
    for s in range(4):
        lin = build.lineages[s]
        assert lin.shard_index == s and lin.slices
        refolded = refold_shard(src, lin, device=CPU)
        for k in ("x", "d", "w", "valid", "num", "n_total"):
            assert torch.equal(getattr(refolded, k), getattr(build.shards[s], k))
        _gran_equal(refolded, build.shards[s])


def test_recover_reproduces_unfailed_build_and_downstream():
    """Lost shard → re-fold + re-merge == the unfailed build, bitwise —
    and therefore byte-identical reducts and Θ histories across ≥3
    measures (the §3.10 parity contract)."""
    src = _stream()
    unfailed = build_sharded(src, 3, chunk_rows=256, device=CPU)
    failed = build_sharded(src, 3, chunk_rows=256, device=CPU)
    failed.drop(1)
    assert failed.lost == [1]
    assert recover(failed, src) == [1]
    for k in ("x", "d", "w", "valid", "num", "n_total"):
        assert torch.equal(getattr(failed.merged, k), getattr(unfailed.merged, k))
    _gran_equal(failed.merged, unfailed.merged)
    for delta in PARITY_DELTAS:
        a = plar_reduce(source=unfailed.merged, delta=delta, device=CPU)
        b = plar_reduce(source=failed.merged, delta=delta, device=CPU)
        _same_reduction(a, b)


def test_sharded_build_equals_jax():
    """The port's sharded build — its lineages, every shard, and the merged
    live prefix (also after a drop and recover) — equals the JAX package's
    on the same source, element for element."""
    src, jsrc = _stream(seed=5), _stream(seed=5, cls=JStream)
    build = build_sharded(src, 3, chunk_rows=256, device=CPU)
    jbuild = j_build_sharded(jsrc, 3, chunk_rows=256)
    assert [lin.to_dict() for lin in build.lineages] == \
        [lin.to_dict() for lin in jbuild.lineages]
    for g, jg in zip(build.shards, jbuild.shards):
        _gran_equal(g, jg)
    _gran_equal(build.merged, jbuild.merged)
    _gran_equal(merge_shards(build.shards), j_merge_shards(jbuild.shards))
    assert build.merged.capacity == jbuild.merged.capacity
    build.drop(2)
    recover(build, src)
    _gran_equal(build.merged, jbuild.merged)


def test_sharded_matches_monolithic_build():
    """The sharded path itself is a parity-preserving build: merged shards
    == one-shard build == the engine's own resolve path."""
    src = _stream(n=700, a=6)
    _gran_equal(build_sharded(src, 5, chunk_rows=200, device=CPU).merged,
                build_sharded(src, 1, chunk_rows=200, device=CPU).merged)


def test_recover_with_cascading_drops_converges():
    """A shard dying *during* recovery is re-folded again — the loop
    converges once the (finite) plan is exhausted."""
    src = _stream()
    unfailed = build_sharded(src, 3, chunk_rows=256, device=CPU)
    plan = FaultPlan.parse("shard_drop@0:2,shard_drop@1:0")
    failed = build_sharded(src, 3, chunk_rows=256, fault_plan=plan, device=CPU)
    assert failed.lost == [2]  # the build-time drop
    recovered = recover(failed, src, fault_plan=plan)
    # shard 2 re-folded, then the plan killed shard 0 mid-recovery
    assert sorted(recovered) == [0, 2] and not failed.lost
    _gran_equal(failed.merged, unfailed.merged)
    assert plan.fired == [("shard_drop", 0), ("shard_drop", 1)]


def test_merge_shards_refuses_lost_shards():
    src = _stream(n=300, a=5)
    build = build_sharded(src, 2, chunk_rows=128, device=CPU)
    build.drop(0)
    with pytest.raises(ValueError, match="recover lost shards first"):
        merge_shards(build.shards)


def test_lineage_dict_roundtrip():
    lin = ShardLineage(shard_index=1, n_shards=4, chunk_rows=256, n_dec=2,
                       v_max=3, exact=True,
                       slices=(ChunkSlice(0, 64, 128), ChunkSlice(1, 64, 128)))
    assert ShardLineage.from_dict(lin.to_dict()) == lin


def test_handle_sharded_lifecycle():
    """DatasetHandle wraps the same machinery: drop → recover keeps the
    fingerprint; an online update retires the lineage (not replayable)."""
    src = _stream(n=600, a=6)
    h = DatasetHandle.create_sharded(src, 3, chunk_rows=200, device=CPU)
    fp = h.fingerprint
    r0 = h.reduce("PR")
    h.drop_shard(0)
    assert h.lost_shards == [0]
    assert h.recover_shards(src) == [0]
    assert h.fingerprint == fp
    assert h.reduce("PR").reduct == r0.reduct
    h.update(*src.chunk(0, 64))  # streamed rows: lineage no longer covers
    assert h.lineage is None
    with pytest.raises(ShardLost):
        h.drop_shard(0)


# ---------------------------------------------------------------------------
# fault plans
# ---------------------------------------------------------------------------


def test_fault_plan_parse_grammar():
    plan = FaultPlan.parse("shard_drop@0:1,dispatch@2x3,merge!@0")
    assert plan.specs[0] == FaultSpec("shard_drop", 0, arg=1)
    assert plan.specs[1] == FaultSpec("dispatch", 2, count=3)
    assert plan.specs[2] == FaultSpec("merge", 0, transient=False)
    with pytest.raises(ValueError, match="unknown fault kind"):
        FaultPlan.parse("frobnicate@0")
    with pytest.raises(ValueError, match="KIND@STEP"):
        FaultPlan.parse("dispatch")


def test_fault_plan_fires_deterministically():
    plan = FaultPlan.parse("dispatch@1x2")
    assert plan.fire("dispatch") is None            # occurrence 0
    with pytest.raises(FaultInjected) as e1:
        plan.inject("dispatch")                     # occurrence 1
    assert e1.value.transient and e1.value.step == 1
    with pytest.raises(FaultInjected):
        plan.inject("dispatch")                     # occurrence 2
    assert plan.fire("dispatch") is None            # occurrence 3: exhausted
    assert plan.fired == [("dispatch", 1), ("dispatch", 2)]
    plan.reset()
    assert plan.fire("dispatch") is None and plan.fired == []


def test_fault_plan_seeded_replayable():
    """Same seed → same plan, and the JAX package's plan, spec for spec."""
    from repro.service import FaultPlan as JFaultPlan

    a = FaultPlan.seeded(7, horizon=16, n_faults=3)
    b = FaultPlan.seeded(7, horizon=16, n_faults=3)
    assert a.specs == b.specs
    assert a.specs != FaultPlan.seeded(8, horizon=16, n_faults=3).specs
    assert repr(a) == repr(JFaultPlan.seeded(7, horizon=16, n_faults=3))


# ---------------------------------------------------------------------------
# durable checkpoints
# ---------------------------------------------------------------------------


def _rows(seed=0, n=500, a=6):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 3, (n, a)).astype(np.int32)
    d = rng.integers(0, 2, (n,)).astype(np.int32)
    return x, d


def _handle(seed=0, n=500, a=6):
    x, d = _rows(seed, n, a)
    return DatasetHandle.create(x, d, n_dec=2, v_max=3, device=CPU), x, d


def test_service_checkpoint_roundtrip(tmp_path):
    h, _x, _d = _handle()
    r = h.reduce("PR")
    h.reduce("SCE", tol=1e-5)
    ck = ServiceCheckpointer(str(tmp_path), device=CPU)
    assert ck.save({"ds": h}) is not None
    step, handles = ck.restore()
    h2 = handles["ds"]
    _gran_equal(h2.gran, h.gran)
    assert h2.fingerprint == h.fingerprint
    assert h2.device == torch.device(CPU)
    assert set(h2._results) == set(h._results)
    got = h2._results[("PR", (("exact", True),))]
    assert got.reduct == r.reduct and got.theta_history == r.theta_history
    # restored handle answers warm, and its repair is byte-identical to the
    # live handle's repair from the same state
    live = h.reduce("PR")
    restored = h2.reduce("PR")
    assert h.last_was_warm and h2.last_was_warm
    assert restored.reduct == live.reduct
    assert restored.theta_history == live.theta_history


def test_checkpoint_written_by_jax_restores_in_port(tmp_path):
    """A step the JAX ``ServiceCheckpointer`` writes restores in the port:
    the same granularity and fingerprint, the same cached results (keys,
    reducts, Θ histories), and a warm repair whose answer equals the JAX
    handle's."""
    x, d = _rows(seed=21, n=600, a=7)
    hj = JHandle.create(x, d, n_dec=2, v_max=3)
    for delta in ("PR", "SCE"):
        hj.reduce(delta)
    JCheckpointer(str(tmp_path)).save({"ds": hj})
    _step, handles = ServiceCheckpointer(str(tmp_path), device=CPU).restore()
    h = handles["ds"]
    _gran_equal(h.gran, hj.gran)
    assert h.fingerprint == hj.fingerprint
    assert set(h._results) == set(hj._results)
    for key, rj in hj._results.items():
        assert h._results[key].reduct == rj.reduct
        assert h._results[key].theta_history == rj.theta_history
    for delta in ("PR", "SCE"):
        warm, warm_j = h.reduce(delta), hj.reduce(delta)
        assert h.last_was_warm and warm.reduct == warm_j.reduct
        if delta == "PR":
            assert warm.theta_history == warm_j.theta_history
        else:
            np.testing.assert_allclose(warm.theta_history, warm_j.theta_history,
                                       rtol=1e-6, atol=1e-7)


def test_checkpoint_written_by_port_restores_in_jax(tmp_path):
    """And the reverse: a port step (a sharded handle, with its lineage)
    restores in the JAX package with an equal fingerprint, results and
    lineage, and the JAX warm repair gives the port's answer."""
    src = _stream(n=600, a=6, seed=4)
    h = DatasetHandle.create_sharded(src, 3, chunk_rows=200, device=CPU)
    r = h.reduce("PR")
    ServiceCheckpointer(str(tmp_path), device=CPU).save({"ds": h})
    _step, handles = JCheckpointer(str(tmp_path)).restore()
    hj = handles["ds"]
    assert hj.fingerprint == h.fingerprint
    _gran_equal(h.gran, hj.gran)
    assert [lin.to_dict() for lin in hj.lineage] == [lin.to_dict() for lin in h.lineage]
    got = hj._results[("PR", (("exact", True),))]
    assert got.reduct == r.reduct and got.theta_history == r.theta_history
    warm_j, warm = hj.reduce("PR"), h.reduce("PR")
    assert warm_j.reduct == warm.reduct and warm_j.theta_history == warm.theta_history


def test_sharded_handle_checkpoint_keeps_lineage(tmp_path):
    src = _stream(n=600, a=6)
    h = DatasetHandle.create_sharded(src, 3, chunk_rows=200, device=CPU)
    ck = ServiceCheckpointer(str(tmp_path), device=CPU)
    ck.save({"ds": h})
    _step, handles = ck.restore()
    h2 = handles["ds"]
    assert h2.lineage is not None and len(h2.lineage) == 3
    assert h2.lineage == h.lineage
    assert h2.fingerprint == h.fingerprint


def test_checkpoint_crash_leaves_previous_step_restorable(tmp_path):
    """An injected crash between staging and commit aborts the step with
    nothing committed — the previous step still restores."""
    h, _x, _d = _handle()
    h.reduce("PR")
    ck = ServiceCheckpointer(str(tmp_path),
                             fault_plan=FaultPlan.parse("checkpoint@1"), device=CPU)
    assert ck.save({"ds": h}) is not None          # step 1 commits
    h.update(*_handle(seed=1)[1:])                  # change content
    assert ck.save({"ds": h}) is None               # step 2: injected crash
    assert ck.failed_saves == 1
    assert isinstance(ck.last_error, FaultInjected)
    step, handles = ck.restore()
    assert step == 1                                # pre-crash state survives
    assert handles["ds"].fingerprint != h.fingerprint


def test_checkpoint_fingerprint_mismatch_is_corrupt(tmp_path):
    h, _x, _d = _handle()
    ck = ServiceCheckpointer(str(tmp_path), device=CPU)
    path = ck.save({"ds": h})
    mpath = os.path.join(path, "manifest.json")
    with open(mpath) as f:
        manifest = json.load(f)
    manifest["extra"]["datasets"]["ds"]["fingerprint"] ^= 0xDEAD
    with open(mpath, "w") as f:
        json.dump(manifest, f)
    with pytest.raises(CheckpointCorrupt, match="fingerprint"):
        ck.restore()


def test_train_restore_skips_corrupt_step(tmp_path):
    """Auto-pick restore degrades to the next older committed step when the
    newest is corrupt (truncated npz), with a warning; an explicitly
    requested corrupt step still raises.  Tensors on ``device`` when one is
    asked for."""
    mgr = CheckpointManager(str(tmp_path), keep=5)
    mgr.save(1, {"w": np.arange(4)})
    mgr.save(2, {"w": torch.arange(8)})
    npz = os.path.join(mgr._path(2), "arrays.npz")
    with open(npz, "wb") as f:
        f.write(b"\x00" * 16)  # committed but garbage
    with pytest.warns(UserWarning, match="skipping corrupt checkpoint"):
        step, tree, _extra = mgr.restore()
    assert step == 1 and len(tree["w"]) == 4
    with pytest.raises(Exception):
        mgr.restore(step=2)
    _step, tree, _extra = mgr.restore(step=1, device=CPU)
    assert isinstance(tree["w"], torch.Tensor) and tree["w"].tolist() == [0, 1, 2, 3]


def test_train_restore_all_corrupt_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"w": np.arange(4)})
    npz = os.path.join(mgr._path(1), "arrays.npz")
    with open(npz, "wb") as f:
        f.write(b"junk")
    with pytest.warns(UserWarning):
        with pytest.raises(FileNotFoundError, match="all 1 committed"):
            mgr.restore()


# ---------------------------------------------------------------------------
# hardened server: restart, flush, retry, quarantine, stale
# ---------------------------------------------------------------------------


def test_server_restart_restores_and_answers_warm(tmp_path):
    """Kill + restart: the new server restores the checkpointed handle and
    serves its first query through the warm repair path."""
    x, d = _rows(seed=3, n=600, a=6)
    ckdir = str(tmp_path)

    async def first_life():
        async with ReductServer(checkpoint_dir=ckdir, device=CPU) as srv:
            await srv.submit("ds", x, d, n_dec=2, v_max=3)
            await srv.query("ds", delta="PR")          # cold
            # run one warm repair on the handle so the checkpoint persists
            # the repair fixed point — exactly what the restarted server's
            # first (warm) query must reproduce byte-for-byte
            r = await asyncio.to_thread(srv.handle("ds").reduce, "PR")
            return r, srv.handle("ds").fingerprint

    r1, fp1 = asyncio.run(first_life())

    async def second_life():
        async with ReductServer(checkpoint_dir=ckdir, device=CPU) as srv:
            assert srv.stats["restored_datasets"] == 1
            assert srv.handle("ds").fingerprint == fp1
            r = await srv.query("ds", delta="PR")
            warm = srv.stats["warm"]
            # and the restored state keeps absorbing updates
            await srv.update("ds", x[:50], d[:50])
            r2 = await srv.query("ds", delta="PR")
            return r, warm, r2

    r2, warm, r3 = asyncio.run(second_life())
    assert r2.reduct == r1.reduct
    assert r2.theta_history == r1.theta_history
    assert warm == 1  # first post-restart query repaired, not recomputed
    assert r3.reduct  # post-restore update still serves


def test_server_stop_flushes_pending_updates(tmp_path):
    """Updates buffered but never demanded by a query are merged by stop()
    — an orderly shutdown never drops accepted updates."""
    x, d = _rows(seed=4, n=400, a=6)
    ckdir = str(tmp_path)

    async def drive():
        srv = ReductServer(checkpoint_dir=ckdir, device=CPU)
        async with srv:
            await srv.submit("ds", x[:200], d[:200], n_dec=2, v_max=3)
            await srv.update("ds", x[200:300], d[200:300])
            await srv.update("ds", x[300:], d[300:])
            # no query: the batches are still buffered at stop()
        return srv.summary(), srv._handles["ds"].fingerprint

    stats, fp = asyncio.run(drive())
    assert stats["flushed_batches"] == 2
    assert stats["merges"] == 1  # both batches in ONE coalesced merge
    full = DatasetHandle.create(x, d, n_dec=2, v_max=3, device=CPU)
    assert fp == full.fingerprint
    # and the final checkpoint captured the flushed state
    _step, handles = ServiceCheckpointer(ckdir, device=CPU).restore()
    assert handles["ds"].fingerprint == full.fingerprint


def test_transient_dispatch_fault_is_retried():
    x, d = _rows(seed=5, n=300, a=6)

    async def drive():
        async with ReductServer(
                fault_plan=FaultPlan.parse("dispatch@0"),
                retry=RetryPolicy(base_delay_s=0.001), device=CPU) as srv:
            await srv.submit("ds", x, d, n_dec=2, v_max=3)
            r = await srv.query("ds", delta="PR")
            return r, dict(srv.stats)

    r, stats = asyncio.run(drive())
    assert r.reduct and not r.stale
    assert stats["retries"] == 1
    assert stats["quarantined"] == 0


def test_fatal_faults_quarantine_then_content_change_clears():
    """A config failing `quarantine_after` times is poisoned: followers get
    QueryPoisoned without re-running the dispatch; a content change (merge)
    clears the quarantine."""
    x, d = _rows(seed=6, n=300, a=6)

    async def drive():
        async with ReductServer(
                fault_plan=FaultPlan.parse("dispatch!@0x2"),
                retry=RetryPolicy(base_delay_s=0.001, quarantine_after=2),
                device=CPU) as srv:
            await srv.submit("ds", x[:250], d[:250], n_dec=2, v_max=3)
            with pytest.raises(FaultInjected):   # fatal: not retried
                await srv.query("ds", delta="PR")
            with pytest.raises(FaultInjected):
                await srv.query("ds", delta="PR")
            assert srv.stats["quarantined"] == 1
            with pytest.raises(QueryPoisoned, match="quarantined"):
                await srv.query("ds", delta="PR")
            runs_before = srv.stats["engine_runs"]
            # content change clears the slate; plan is exhausted → success
            await srv.update("ds", x[250:], d[250:])
            r = await srv.query("ds", delta="PR")
            return r, runs_before, dict(srv.stats)

    r, runs_before, stats = asyncio.run(drive())
    assert r.reduct
    assert runs_before == 0          # poisoned follower never hit the engine
    assert stats["retries"] == 0     # fatal faults are not retried


def test_serve_stale_degrades_to_last_good():
    """serve_stale=True: a failed dispatch serves the last known-good
    result flagged stale=True instead of erroring."""
    x, d = _rows(seed=7, n=300, a=6)

    async def drive():
        async with ReductServer(
                fault_plan=FaultPlan.parse("dispatch!@1x3"),
                retry=RetryPolicy(base_delay_s=0.001),
                serve_stale=True, device=CPU) as srv:
            await srv.submit("ds", x[:250], d[:250], n_dec=2, v_max=3)
            good = await srv.query("ds", delta="PR")   # occurrence 0: fine
            await srv.update("ds", x[250:], d[250:])   # cache now misses
            degraded = await srv.query("ds", delta="PR")
            return good, degraded, dict(srv.stats)

    good, degraded, stats = asyncio.run(drive())
    assert not good.stale
    assert degraded.stale
    assert degraded.reduct == good.reduct
    assert stats["stale_served"] == 1


def test_stopped_server_raises_typed_error():
    async def drive():
        srv = ReductServer(device=CPU)
        async with srv:
            await srv.submit("ds", np.zeros((4, 2), np.int32),
                             np.zeros((4,), np.int32), n_dec=2, v_max=2)
        from repro_torch.service import ServiceError
        with pytest.raises(ServiceError, match="not started"):
            srv._ensure_running()  # fully stopped == not started
        srv._stopping = True
        with pytest.raises(ServerStopped, match="server stopped"):
            srv._ensure_running()  # mid-shutdown: the typed stop error
        srv._stopping = False
        # the hierarchy: every typed error is still a RuntimeError
        assert issubclass(ServerStopped, RuntimeError)
        assert issubclass(QueryPoisoned, RuntimeError)

    asyncio.run(drive())


# ---------------------------------------------------------------------------
# repair_reduce under adversarial inputs
# ---------------------------------------------------------------------------


def test_repair_empty_previous_is_cold_run():
    h, x, d = _handle(seed=8)
    cold = plar_reduce(x, d, delta="PR", n_dec=2, v_max=3, device=CPU)
    r, kept = repair_reduce(h.gran, [], delta="PR")
    assert kept == 0
    assert r.reduct == cold.reduct and r.theta_history == cold.theta_history


def test_repair_out_of_range_previous_is_sanitized():
    """A reduct referencing attributes beyond the table (a checkpoint from
    a wider schema) must not crash or corrupt the result: bad attributes
    are dropped from the warm hint, the answer matches the cold run."""
    h, x, d = _handle(seed=9)
    cold = plar_reduce(x, d, delta="PR", n_dec=2, v_max=3, device=CPU)
    bad = list(cold.reduct) + [h.gran.n_attrs + 3, -1, cold.reduct[0]]
    r, _kept = repair_reduce(h.gran, bad, delta="PR")
    assert r.reduct == cold.reduct
    assert r.theta_history == cold.theta_history
    # entirely-garbage previous degrades to a cold run
    r2, kept2 = repair_reduce(h.gran, [99, 99, -5], delta="PR")
    assert kept2 == 0 and r2.reduct == cold.reduct


def test_noop_update_racing_checkpoint_restore(tmp_path):
    """A fingerprint-unchanged no-op update between checkpoint and restore
    must leave the restored handle fully consistent — same fingerprint,
    warm repair still valid."""
    h, _x, _d = _handle(seed=10)
    h.reduce("PR")
    ck = ServiceCheckpointer(str(tmp_path), device=CPU)
    ck.save({"ds": h})
    # empty batch: counted, but content (and fingerprint) unchanged
    h.update(np.zeros((0, h.gran.n_attrs), np.int32), np.zeros((0,), np.int32))
    assert h.n_updates == 1
    _step, handles = ck.restore()
    h2 = handles["ds"]
    assert h2.fingerprint == h.fingerprint
    # both warm-repair from the same persisted state → identical answers
    live, restored = h.reduce("PR"), h2.reduce("PR")
    assert h.last_was_warm and h2.last_was_warm
    assert restored.reduct == live.reduct
    assert restored.theta_history == live.theta_history
