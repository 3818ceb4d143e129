"""The port's multi-tenant serving tier (``repro_torch.service``, DESIGN.md
§3.9) on the CPU: batched dispatch, dedup, admission control, metrics —
and the two places where a CUDA card changes what the JAX scheduler's
threads mean: the device guard that keeps merges out of engine captures,
and timed-out dispatches that are adopted by their retry, never raced.

Mirrors ``tests/test_scheduler.py``: K concurrent clients with mixed
measures on one dataset are answered from ≤2 stacked dispatches with
results byte-identical to solo ``query()`` calls; C identical concurrent
queries collapse to ONE engine run; submits above the bounded queue depth
fail fast with ``ServerOverloaded``; ``stop()`` fails queued-but-unstarted
futures.  Stacked and sequential repairs are held against the JAX
package's on the same seeded tables (reducts and prefix lengths exact, Θ_PR
bit-equal, SCE/LCE/CCE within rtol=1e-6, atol=1e-7).
"""
import asyncio
import threading
import time

import numpy as np
import pytest
import torch

from repro.core.reduction import plar_reduce as j_plar
from repro.core.reduction import plar_reduce_ensemble as j_ensemble
from repro.service import DatasetHandle as JHandle
from repro.service import repair_reduce_many as j_repair_many
from repro_torch.core import engine
from repro_torch.core.guard import DeviceGuard, device_guard
from repro_torch.core.reduction import (
    partition_reduce_params,
    plar_reduce,
    plar_reduce_ensemble,
)
from repro_torch.service import (
    DatasetHandle,
    ReductServer,
    RetryPolicy,
    ServerOverloaded,
    repair_reduce,
    repair_reduce_many,
)
from repro_torch.service.scheduler import _call_with_timeout

# The tensors here are tiny: PyTorch's intra-op thread pool only adds
# overhead, and across pytest-xdist workers it oversubscribes the cores.
torch.set_num_threads(1)

DELTAS = ["PR", "SCE", "LCE", "CCE"]
CPU = "cpu"


def _table(seed, n, a, vmax=3, m=3, redundancy=0.5):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, vmax, size=(n, a)).astype(np.int32)
    for j in range(1, a):
        if rng.random() < redundancy:
            x[:, j] = x[:, rng.integers(0, j)]
    d = rng.integers(0, m, size=(n,)).astype(np.int32)
    return x, d


def _same_result(a, b):
    assert a.reduct == b.reduct
    assert np.array_equal(np.asarray(a.theta_history),
                          np.asarray(b.theta_history))
    assert a.theta_full == b.theta_full


def _near_jax(delta, rt, rj):
    assert rt.reduct == rj.reduct
    if delta == "PR":
        assert rt.theta_history == rj.theta_history
    else:
        np.testing.assert_allclose(rt.theta_history, rj.theta_history, rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# ensemble driver: per-config warm_start (the batched-repair enabler)
# ---------------------------------------------------------------------------


def test_ensemble_warm_start_matches_solo_warm():
    """A stacked member with ``warm_start`` is byte-identical to the solo
    ``plar_reduce(warm_start=...)`` run it batches — full prefix, partial
    prefix, and a cold member in the same grid — and matches JAX's grid."""
    x, d = _table(0, 500, 8)
    solo_cold = plar_reduce(x, d, delta="PR", device=CPU)
    prefix = solo_cold.reduct[:2]
    grid = [
        {"delta": "PR", "warm_start": solo_cold.reduct},
        {"delta": "PR", "warm_start": prefix},
        {"delta": "SCE"},
    ]
    stacked = plar_reduce_ensemble(x, d, configs=grid, device=CPU)
    _same_result(stacked[0], plar_reduce(x, d, delta="PR", warm_start=solo_cold.reduct,
                                         device=CPU))
    _same_result(stacked[1], plar_reduce(x, d, delta="PR", warm_start=prefix, device=CPU))
    _same_result(stacked[2], plar_reduce(x, d, delta="SCE", device=CPU))
    for c, rt, rj in zip(grid, stacked, j_ensemble(x, d, configs=grid)):
        _near_jax(c["delta"], rt, rj)


def test_ensemble_warm_start_validation():
    x, d = _table(1, 200, 5)
    with pytest.raises(ValueError, match="warm_start"):
        plar_reduce_ensemble(
            x, d, configs=[{"delta": "PR", "warm_start": [0, 0]}], device=CPU)
    with pytest.raises(ValueError, match="warm_start"):
        plar_reduce(x, d, delta="PR", warm_start=[99], device=CPU)


def test_partition_reduce_params_split():
    """Per-config knobs route to the stacked grid, shared knobs to the
    dispatch; anything the ensemble cannot express refuses to split."""
    split = partition_reduce_params("PR", {"tol": 1e-4, "backend": "segment"})
    assert split is not None
    config, shared = split
    assert config == {"delta": "PR", "tol": 1e-4}
    assert shared == {"backend": "segment"}
    assert partition_reduce_params("PR", {"engine": "host"}) is None
    assert partition_reduce_params("PR", {"backend": "fused"}) is None
    assert partition_reduce_params("PR", {"mode": "sprak"}) is None


def test_repair_reduce_many_matches_sequential_repair():
    """Stacked warm repair over mixed measures == each measure's solo
    repair, byte for byte, including a member whose prefix is trimmed; and
    both equal the JAX package's stacked repair."""
    x, d = _table(2, 700, 9)
    h = DatasetHandle.create(x[:500], d[:500], n_dec=3, v_max=3, device=CPU)
    h2 = DatasetHandle.create(x[:500], d[:500], n_dec=3, v_max=3, device=CPU)
    hj = JHandle.create(x[:500], d[:500], n_dec=3, v_max=3)
    prevs = {m: h.reduce(m) for m in DELTAS}
    for m in DELTAS:
        h2.reduce(m)
    for hh in (h, h2, hj):
        hh.update(x[500:], d[500:])
    configs = [{"delta": m} for m in DELTAS]
    results, kept = repair_reduce_many(
        h.gran, configs, [prevs[m].reduct for m in DELTAS], exact=True)
    results_j, kept_j = j_repair_many(
        hj.gran, configs, [prevs[m].reduct for m in DELTAS], exact=True)
    assert kept == kept_j
    for m, r, k, rj in zip(DELTAS, results, kept, results_j):
        solo = h2.reduce(m)      # solo warm path (repair_reduce)
        _same_result(r, solo)
        _near_jax(m, r, rj)
        assert k <= len(prevs[m].reduct)


# ---------------------------------------------------------------------------
# scheduler: batched dispatch + parity
# ---------------------------------------------------------------------------


def test_concurrent_clients_batched_into_stacked_dispatches():
    """K clients × mixed measures/params on one dataset are served from ≤2
    stacked dispatches, byte-identical to solo query() calls — through a
    streaming update too (stacked warm repair)."""
    x, d = _table(3, 800, 10)

    async def drive():
        specs = [("PR", {}), ("SCE", {}), ("LCE", {}), ("CCE", {}),
                 ("PR", {"tol": 1e-4}), ("SCE", {"max_features": 3})]
        async with ReductServer(device=CPU) as srv, \
                ReductServer(batching=False, device=CPU) as ref:
            for s in (srv, ref):
                await s.submit("s", x[:600], d[:600], n_dec=3, v_max=3)
            rs = await asyncio.gather(
                *[srv.query("s", m, **p) for m, p in specs])
            runs_cold = srv.stats["engine_runs"]
            # cold twins from the single-flight reference server
            for (m, p), r in zip(specs, rs):
                _same_result(r, await ref.query("s", m, **p))
            for (m, p), r in zip(specs[:4], rs[:4]):
                _near_jax(m, r, j_plar(x[:600], d[:600], delta=m, n_dec=3, v_max=3))
            # firehose round: update lands, then another concurrent window
            for s in (srv, ref):
                await s.update("s", x[600:], d[600:])
            rs2 = await asyncio.gather(
                *[srv.query("s", m, **p) for m, p in specs])
            runs_warm = srv.stats["engine_runs"] - runs_cold
            # warm twins: solo warm repair vs stacked warm repair
            for (m, p), r2 in zip(specs, rs2):
                _same_result(r2, await ref.query("s", m, **p))
            assert runs_cold <= 2
            assert runs_warm <= 2
            occ = srv.metrics.mean_occupancy()
            assert occ > 1.0  # real cross-query batching happened
            assert srv.metrics.counters["engine_dispatches"] == \
                srv.stats["engine_runs"]

    asyncio.run(drive())


def test_unbatchable_params_fall_back_to_solo():
    """Params the stacked engine cannot express (engine='host') still work —
    they take the solo path inside the same window."""
    x, d = _table(4, 400, 6)

    async def drive():
        async with ReductServer(device=CPU) as srv:
            await srv.submit("s", x, d, n_dec=3, v_max=3)
            r_host, r_dev = await asyncio.gather(
                srv.query("s", "PR", engine="host"),
                srv.query("s", "SCE"))
            solo = plar_reduce(x, d, delta="PR", engine="host", device=CPU)
            assert r_host.reduct == solo.reduct
            _near_jax("PR", r_host, j_plar(x, d, delta="PR", engine="host"))
            assert r_dev.reduct  # served, from the same window

    asyncio.run(drive())


def test_inflight_dedup_collapses_identical_queries():
    """C identical concurrent queries → exactly 1 engine run; every caller
    gets the same result object.  Numpy-scalar params dedup with python
    floats (normalized keys)."""
    x, d = _table(5, 500, 8)

    async def drive():
        async with ReductServer(device=CPU) as srv:
            await srv.submit("s", x, d, n_dec=3, v_max=3)
            tols = [1e-4, np.float32(1e-4), np.float64(1e-4), 1e-4, 1e-4]
            rs = await asyncio.gather(
                *[srv.query("s", "PR", tol=t) for t in tols])
            assert srv.stats["engine_runs"] == 1
            assert srv.stats["dedup_hits"] == len(tols) - 1
            assert all(r is rs[0] for r in rs)

    asyncio.run(drive())


def test_result_cache_key_normalization():
    """Sequential repeats with numpy-scalar params hit the result cache
    instead of minting distinct entries."""
    x, d = _table(6, 400, 6)

    async def drive():
        async with ReductServer(device=CPU) as srv:
            await srv.submit("s", x, d, n_dec=3, v_max=3)
            await srv.query("s", "PR", tol=1e-4, max_features=4)
            r2 = await srv.query("s", "PR", tol=np.float32(1e-4),
                                 max_features=np.int64(4))
            assert srv.stats["cache_hits"] == 1
            assert len(srv._cache) == 1
            assert r2.reduct

    asyncio.run(drive())


def test_stale_eviction_uses_per_dataset_index():
    """A merge evicts exactly the updated dataset's superseded entries; the
    other dataset's cache and the index stay consistent."""
    x1, d1 = _table(7, 500, 7)
    x2, d2 = _table(8, 500, 7)

    async def drive():
        async with ReductServer(device=CPU) as srv:
            await srv.submit("a", x1[:400], d1[:400], n_dec=3, v_max=3)
            await srv.submit("b", x2, d2, n_dec=3, v_max=3)
            await asyncio.gather(srv.query("a", "PR"), srv.query("a", "SCE"),
                                 srv.query("b", "PR"))
            assert len(srv._cache) == 3
            await srv.update("a", x1[400:], d1[400:])
            await srv.query("a", "PR")
            keys = set(srv._cache)
            assert {k[0] for k in keys} == {"a", "b"}
            # b untouched; a's stale-fingerprint entries gone
            assert sum(1 for k in keys if k[0] == "b") == 1
            assert sum(1 for k in keys if k[0] == "a") == 1
            # index mirrors the cache exactly
            indexed = {k for by_fp in srv._cache_index.values()
                       for ks in by_fp.values() for k in ks}
            assert indexed == keys

    asyncio.run(drive())


def test_stacked_group_order_is_canonical():
    """The same set of configs arriving in another order replays the same
    ensemble runner (the port keys its runner, and CUDA graph, on the
    ordered measures), and every client still gets its own config's
    answer."""
    x, d = _table(12, 500, 8)

    async def drive():
        async with ReductServer(device=CPU) as srv:
            await srv.submit("s", x, d, n_dec=3, v_max=3)
            first = await asyncio.gather(*[srv.query("s", m) for m in DELTAS])
            runners = engine._runner.cache_info().currsize
            await srv.update("s", x[:7], d[:7])
            order = ["CCE", "PR", "LCE", "SCE"]
            second = await asyncio.gather(*[srv.query("s", m) for m in order])
            assert engine._runner.cache_info().currsize == runners
            assert srv.stats["engine_runs"] == 2
            gran = srv.handle("s").gran
            for m, r in zip(order, second):
                prev = first[DELTAS.index(m)].reduct
                _same_result(r, repair_reduce(gran, prev, delta=m, exact=True)[0])

    asyncio.run(drive())


# ---------------------------------------------------------------------------
# admission control + lifecycle
# ---------------------------------------------------------------------------


def test_backpressure_rejects_above_depth_and_recovers():
    x, d = _table(9, 400, 6)

    async def drive():
        async with ReductServer(max_queue=3, device=CPU) as srv:
            await srv.submit("s", x, d, n_dec=3, v_max=3)
            # distinct params so dedup cannot absorb them; created together
            # so all submits land before the scheduler drains the window
            tasks = [asyncio.create_task(
                srv.query("s", "PR", max_features=i + 1)) for i in range(5)]
            done = await asyncio.gather(*tasks, return_exceptions=True)
            rejected = [r for r in done if isinstance(r, ServerOverloaded)]
            served = [r for r in done if not isinstance(r, Exception)]
            assert len(rejected) == 2 and len(served) == 3
            assert srv.stats["rejected"] == 2
            # queue drained: the server admits again
            r = await srv.query("s", "SCE")
            assert r.reduct
            assert srv.metrics.counters["rejected"] == 2

    asyncio.run(drive())


def test_stop_fails_queued_requests():
    """stop() drains the queue and fails pending futures with a clear
    RuntimeError instead of leaving them hanging forever."""
    x, d = _table(10, 300, 5)

    async def drive():
        srv = ReductServer(device=CPU)
        await srv.start()
        await srv.submit("s", x, d, n_dec=3, v_max=3)
        t1 = asyncio.create_task(srv.query("s", "PR"))
        t2 = asyncio.create_task(srv.query("s", "SCE"))
        await asyncio.sleep(0)   # both enqueue; scheduler not yet dispatched
        await srv.stop()
        for t in (t1, t2):
            with pytest.raises(RuntimeError, match="server stopped"):
                await t
        # queries during/after stop are refused, not hung
        with pytest.raises(RuntimeError):
            await srv.query("s", "PR")

    asyncio.run(drive())


def test_metrics_timing_and_summary_shape():
    x, d = _table(11, 300, 5)

    async def drive():
        async with ReductServer(device=CPU) as srv:
            await srv.submit("s", x, d, n_dec=3, v_max=3)
            await asyncio.gather(srv.query("s", "PR"), srv.query("s", "SCE"))
            s = srv.summary()
            for k in ("completed", "engine_dispatches", "qps_sustained",
                      "mean_batch_occupancy", "queue_wait_p50_s",
                      "latency_p99_s", "queries", "engine_runs"):
                assert k in s
            assert s["completed"] == 2
            req = srv.requests[-1]
            assert req.timing.t_done >= req.timing.t_start >= \
                req.timing.t_enqueue > 0.0
            assert req.latency_s == pytest.approx(req.timing.service_s)

    asyncio.run(drive())


# ---------------------------------------------------------------------------
# the device guard: merges against captures (the card's test is in
# test_torch_cuda.py; here the guard itself, held by hand)
# ---------------------------------------------------------------------------


def test_merge_waits_while_the_capture_guard_is_held():
    """A merge on another thread waits while the device guard is held
    exclusively (as a capture holds it), and completes, with the right
    content, once it is released; the guard counts the wait."""
    x, d = _table(13, 600, 6)
    h = DatasetHandle.create(x[:300], d[:300], n_dec=3, v_max=3, device=CPU)
    guard = device_guard(CPU)
    waits = guard.shared_waits
    done = threading.Event()

    def merge():
        h.update(x[300:], d[300:])
        done.set()

    with guard.exclusive():
        t = threading.Thread(target=merge)
        t.start()
        assert not done.wait(0.3)            # held off by the "capture"
        assert h.rows_absorbed == 300
    t.join(10)
    assert done.is_set() and h.rows_absorbed == 600
    assert guard.shared_waits == waits + 1
    full = DatasetHandle.create(x, d, n_dec=3, v_max=3, device=CPU)
    assert h.fingerprint == full.fingerprint


def test_device_guard_semantics():
    """Shared holds run together and nest; an exclusive hold waits for them
    and has priority over new shared holds; a shared holder asking for
    exclusive raises instead of waiting on itself."""
    g = DeviceGuard()
    log = []

    def reader(tag):
        with g.shared():
            log.append(tag)

    def writer():
        with g.exclusive():
            log.append("w")

    with g.shared():
        with g.shared():                     # nests on one thread
            pass
        r2 = threading.Thread(target=reader, args=("r2",))
        r2.start()
        r2.join(5)
        assert log == ["r2"]                 # readers run together
        with pytest.raises(RuntimeError, match="shared"):
            with g.exclusive():
                pass
        w = threading.Thread(target=writer)
        w.start()
        deadline = time.monotonic() + 10
        while g._writers_waiting != 1 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert g._writers_waiting == 1
        assert log == ["r2"]                 # the writer waits for the reader
        r3 = threading.Thread(target=reader, args=("r3",))
        r3.start()
        time.sleep(0.1)
        assert log == ["r2"]                 # a waiting writer keeps new readers out
    w.join(5)
    r3.join(5)
    assert not w.is_alive() and not r3.is_alive()
    assert log == ["r2", "w", "r3"]
    assert g.capture_waits == 1 and g.shared_waits == 1


def test_device_guard_stress():
    """Many more threads than cores take the guard shared and exclusively
    under a short switch interval: no shared holder ever runs beside an
    exclusive one, no two exclusive holders overlap, and every thread ends."""
    import os
    import sys

    g = DeviceGuard()
    state = {"readers": 0, "writers": 0, "bad": 0, "ops": 0}
    lock = threading.Lock()

    def reader():
        for _ in range(200):
            with g.shared():
                with lock:
                    state["readers"] += 1
                    state["bad"] += state["writers"] != 0
                time.sleep(0)                # let other threads in while it is held
                with lock:
                    state["readers"] -= 1
                    state["ops"] += 1

    def writer():
        for _ in range(50):
            with g.exclusive():
                with lock:
                    state["writers"] += 1
                    state["bad"] += state["writers"] != 1 or state["readers"] != 0
                time.sleep(0)
                with lock:
                    state["writers"] -= 1
                    state["ops"] += 1

    n = 4 * (os.cpu_count() or 2)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=reader if i % 4 else writer) for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert state["bad"] == 0
    assert state["ops"] == sum(200 if i % 4 else 50 for i in range(n))


def test_dispatches_serialize_on_the_dispatch_lock():
    """A handle's reduction holds its device's dispatch lock: a dispatch on
    another thread waits while it is held (runners share their buffers)."""
    x, d = _table(14, 300, 6)
    h = DatasetHandle.create(x, d, n_dec=3, v_max=3, device=CPU)
    done = threading.Event()
    with device_guard(CPU).dispatch:
        t = threading.Thread(target=lambda: (h.reduce("PR"), done.set()))
        t.start()
        assert not done.wait(0.3)
    t.join(30)
    assert done.is_set()


# ---------------------------------------------------------------------------
# timeouts: the retry adopts the running call
# ---------------------------------------------------------------------------


def test_call_with_timeout_adopts_the_running_call():
    calls = []

    def slow():
        calls.append(1)
        time.sleep(0.3)
        return "answer"

    with pytest.raises(TimeoutError) as e:
        _call_with_timeout(slow, 0.05)
    running = e.value.running
    assert _call_with_timeout(slow, 1.0, running) == "answer"
    assert calls == [1]                      # fn ran once
    assert _call_with_timeout(lambda: 7, None) == 7


def test_timed_out_dispatch_retry_gives_the_untimed_answer(monkeypatch):
    """A dispatch slower than ``timeout_s`` times out; its retry waits on
    the same running call instead of starting a second one, so the engine
    runs once and the answer is the untimed server's, byte for byte."""
    x, d = _table(15, 500, 8)
    calls = []
    real = DatasetHandle.reduce

    def slow_reduce(self, *a, **kw):
        calls.append(threading.get_ident())
        time.sleep(0.4)
        return real(self, *a, **kw)

    async def serve(retry):
        async with ReductServer(retry=retry, device=CPU) as srv:
            await srv.submit("s", x, d, n_dec=3, v_max=3)
            r = await srv.query("s", "SCE", backend="sweep")
            return r, dict(srv.stats)

    untimed, _ = asyncio.run(serve(None))
    monkeypatch.setattr(DatasetHandle, "reduce", slow_reduce)
    timed, stats = asyncio.run(serve(RetryPolicy(timeout_s=0.1, max_attempts=10,
                                                 base_delay_s=0.001)))
    assert len(calls) == 1                   # one engine run, adopted by the retries
    assert stats["retries"] >= 1 and stats["quarantined"] == 0
    _same_result(timed, untimed)
    assert timed.core == untimed.core and timed.iterations == untimed.iterations
