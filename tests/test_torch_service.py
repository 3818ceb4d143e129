"""The port's online reduct service (``repro_torch.service``, DESIGN.md §3.7)
on the CPU, held against the JAX package's ``repro.service``.

Mirrors ``tests/test_service.py``: a dataset created from the first half of
a paper table and streamed the second half in 4 update batches ends with
the reduct of a batch ``plar_reduce`` over the full table, for all four
measures, while every update costs one monoid merge plus a warm repair.
Each test feeds the same seeded numpy inputs to both packages where both
can run it.  Tolerances: reducts, cores, prefix lengths, granule tables and
fingerprints exact; Θ_PR histories bit-equal; SCE/LCE/CCE within rtol=1e-6,
atol=1e-7 (the f32 tolerance of the port's other parity tests).  Inside the
port, warm and cold runs and streamed and batch runs are byte-identical.
"""
import asyncio
from functools import lru_cache

import numpy as np
import pytest
import torch

from repro.core import build_granularity as j_build
from repro.core import plar_reduce as j_plar
from repro.data import TabularStream as JStream
from repro.service import DatasetHandle as JHandle
from repro.service import granularity_fingerprint as j_fingerprint
from repro.service import repair_reduce as j_repair
from repro_torch.core import build_granularity, plar_reduce, with_capacity
from repro_torch.core.granularity import build_granularity_streaming
from repro_torch.data import TabularStream, scaled_paper_dataset
from repro_torch.service import (
    DatasetHandle,
    ReductServer,
    granularity_fingerprint,
    repair_reduce,
    valid_prefix_len,
)

# The tensors here are tiny: PyTorch's intra-op thread pool only adds
# overhead, and across pytest-xdist workers it oversubscribes the cores.
torch.set_num_threads(1)

DELTAS = ["PR", "SCE", "LCE", "CCE"]
CPU = "cpu"


def _table(rng, n, a, vmax=3, m=2, redundancy=0.5):
    x = rng.integers(0, vmax, size=(n, a)).astype(np.int32)
    for j in range(1, a):
        if rng.random() < redundancy:
            x[:, j] = x[:, rng.integers(0, j)]
    d = rng.integers(0, m, size=(n,)).astype(np.int32)
    return x, d


def _build(x, d, **kw):
    return build_granularity(torch.as_tensor(x), torch.as_tensor(d), **kw)


def _assert_jax(delta, rt, rj):
    assert rt.reduct == rj.reduct
    if delta == "PR":
        assert rt.theta_history == rj.theta_history          # bit-identical floats
    else:
        np.testing.assert_allclose(rt.theta_history, rj.theta_history, rtol=1e-6, atol=1e-7)


@lru_cache(maxsize=None)
def _shuttle():
    stream = scaled_paper_dataset("shuttle", max_rows=4000, max_attrs=9)
    return stream, stream.table()


@lru_cache(maxsize=None)
def _jax_batch(delta):
    stream, (x, d) = _shuttle()
    return j_plar(x, d, delta=delta, n_dec=stream.n_dec, v_max=stream.v_max)


# ---------------------------------------------------------------------------
# DatasetHandle: state + updates + fingerprint
# ---------------------------------------------------------------------------


def test_handle_update_matches_batch_granularity():
    """Half + streamed updates == the JAX package's monolithic build (live
    prefix and fingerprint), and capacity follows the pow2 policy."""
    rng = np.random.default_rng(0)
    x, d = _table(rng, 600, 6, vmax=4, m=3)
    h = DatasetHandle.create(x[:300], d[:300], n_dec=3, v_max=4, device=CPU)
    for lo in range(300, 600, 100):
        h.update(x[lo:lo + 100], d[lo:lo + 100])
    mono = j_build(x, d, n_dec=3, v_max=4)
    num = int(mono.num)
    assert h.n_granules == num
    np.testing.assert_array_equal(h.gran.x.numpy()[:num], np.asarray(mono.x)[:num])
    np.testing.assert_array_equal(h.gran.w.numpy()[:num], np.asarray(mono.w)[:num])
    assert h.gran.capacity == (1 << (num - 1).bit_length())
    assert h.n_updates == 3 and h.rows_absorbed == 600
    assert h.fingerprint == j_fingerprint(mono)
    assert h.device == torch.device(CPU)


def test_fingerprint_content_invariance():
    """Fingerprint is a pure function of live content: invariant to padding
    capacity and build path, sensitive to rows and to multiplicities."""
    rng = np.random.default_rng(1)
    x, d = _table(rng, 200, 5)
    g = _build(x, d, n_dec=2, v_max=3)
    assert granularity_fingerprint(g) == granularity_fingerprint(
        with_capacity(g, 4 * g.capacity))
    g2 = _build(x[:199], d[:199], n_dec=2, v_max=3)
    assert granularity_fingerprint(g) != granularity_fingerprint(g2)
    # duplicating a row changes only a weight — still a different content
    xd = np.concatenate([x, x[:1]])
    dd = np.concatenate([d, d[:1]])
    g3 = _build(xd, dd, n_dec=2, v_max=3)
    assert granularity_fingerprint(g) != granularity_fingerprint(g3)


@pytest.mark.parametrize("n,a,vmax,m,seed", [(200, 5, 3, 2, 1), (3000, 12, 7, 5, 2),
                                             (8000, 9, 250, 3, 3)])
def test_fingerprint_equals_jax(n, a, vmax, m, seed):
    """The port's fingerprint equals the JAX package's bit for bit on the
    same rows, built monolithically and streamed in chunks, including
    tables whose uint32 sums wrap around many times."""
    rng = np.random.default_rng(seed)
    x, d = _table(rng, n, a, vmax=vmax, m=m, redundancy=0.2)
    want = j_fingerprint(j_build(x, d, n_dec=m, v_max=vmax))
    assert granularity_fingerprint(_build(x, d, n_dec=m, v_max=vmax)) == want
    chunks = [(x[lo:lo + 701], d[lo:lo + 701]) for lo in range(0, n, 701)]
    streamed = build_granularity_streaming(chunks, n_dec=m, v_max=vmax, device=CPU)
    assert granularity_fingerprint(streamed) == want
    # and a JAX handle streamed over a TabularStream's chunks
    src, jsrc = (cls(n_rows=n, n_attrs=a, v_max=vmax, n_dec=m, distinct_fraction=0.4, seed=seed)
                 for cls in (TabularStream, JStream))
    h = DatasetHandle.create(source=src, chunk_rows=997, device=CPU)
    assert h.fingerprint == JHandle.create(source=jsrc, chunk_rows=997).fingerprint


def test_handle_create_and_update_validation():
    rng = np.random.default_rng(2)
    x, d = _table(rng, 100, 4)
    with pytest.raises(ValueError, match="n_dec and v_max"):
        DatasetHandle.create(x, d, device=CPU)
    h = DatasetHandle.create(x, d, n_dec=2, v_max=3, device=CPU)
    with pytest.raises(ValueError, match="attributes"):
        h.update(x[:, :3], d)
    with pytest.raises(ValueError, match="decision shape"):
        h.update(x, d[:-1])
    with pytest.raises(ValueError, match="v_max"):
        h.update(np.full((2, 4), 3, np.int32), np.zeros((2,), np.int32))
    with pytest.raises(ValueError, match="n_dec"):
        h.update(np.zeros((2, 4), np.int32), np.full((2,), 2, np.int32))
    # negative codes would scatter out of range downstream — rejected here,
    # before they can corrupt the merged granularity
    with pytest.raises(ValueError, match="v_max"):
        h.update(np.full((2, 4), -1, np.int32), np.zeros((2,), np.int32))
    with pytest.raises(ValueError, match="n_dec"):
        h.update(np.zeros((2, 4), np.int32), np.full((2,), -1, np.int32))
    # empty batch is identity on the granularity
    before = h.fingerprint
    h.update(np.zeros((0, 4), np.int32), np.zeros((0,), np.int32))
    assert h.fingerprint == before
    # the device rule: no card is an error, never a silent CPU run
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            DatasetHandle.create(x, d, n_dec=2, v_max=3)


# ---------------------------------------------------------------------------
# repair: validate (fold) → trim → resume
# ---------------------------------------------------------------------------


def test_valid_prefix_len():
    # every fold improves, target unreached → keep all
    assert valid_prefix_len([0.5, 0.3, 0.1], theta_full=0.0) == 3
    # third fold no longer improves beyond tie_tol → trim it and the tail
    assert valid_prefix_len([0.5, 0.3, 0.3, 0.1], theta_full=0.0) == 2
    # stopping target reached mid-prefix → later attributes are redundant
    assert valid_prefix_len([0.5, 0.3, 0.1], theta_full=0.3) == 2
    assert valid_prefix_len([], theta_full=0.0) == 0


def test_repair_is_noop_on_unchanged_data():
    """Full prefix valid + target reached → the probe IS the result: zero
    greedy iterations, byte-identical Θ history — and the JAX repair's."""
    rng = np.random.default_rng(3)
    x, d = _table(rng, 250, 8)
    cold = plar_reduce(x, d, delta="SCE", device=CPU)
    gran = _build(x, d, n_dec=2, v_max=3)
    r, kept = repair_reduce(gran, cold.reduct, delta="SCE")
    assert kept == len(cold.reduct)
    assert r.reduct == cold.reduct
    assert r.theta_history == cold.theta_history
    assert r.iterations == 0
    rj, kept_j = j_repair(j_build(x, d, n_dec=2, v_max=3), cold.reduct, delta="SCE")
    assert kept_j == kept
    _assert_jax("SCE", r, rj)


def test_repair_trims_redundant_prefix():
    """A prefix attribute that no longer improves Θ (a copy of an earlier
    one) is dropped, and the resumed greedy never re-selects it."""
    rng = np.random.default_rng(4)
    x, d = _table(rng, 250, 8, redundancy=0.0)
    x[:, 3] = x[:, 2]  # attr 3 is redundant once 2 is selected
    gran = _build(x, d, n_dec=2, v_max=3)
    r, kept = repair_reduce(gran, [2, 3], delta="SCE")
    assert kept == 1
    assert r.reduct[0] == 2 and 3 not in r.reduct
    rj, kept_j = j_repair(j_build(x, d, n_dec=2, v_max=3), [2, 3], delta="SCE")
    assert kept_j == kept
    _assert_jax("SCE", r, rj)


@pytest.mark.parametrize("delta", DELTAS)
def test_handle_reduce_warm_matches_cold(delta):
    """After an update, the warm repair and a cold run on the same handle
    agree byte for byte, and the warm repair equals the JAX handle's (a
    paper stand-in whose attribute significances are well separated)."""
    stream = scaled_paper_dataset("breast-cancer-wisconsin", max_rows=683, max_attrs=9)
    x, d = stream.table()
    h = DatasetHandle.create(x[:500], d[:500], n_dec=stream.n_dec, v_max=stream.v_max,
                             device=CPU)
    hj = JHandle.create(x[:500], d[:500], n_dec=stream.n_dec, v_max=stream.v_max)
    for hh in (h, hj):
        hh.reduce(delta)
        hh.update(x[500:], d[500:])
    warm = h.reduce(delta)
    assert h.last_was_warm and h.last_prefix_kept > 0
    warm_j = hj.reduce(delta)
    assert h.last_prefix_kept == hj.last_prefix_kept
    _assert_jax(delta, warm, warm_j)
    cold = h.reduce(delta, warm=False)
    assert warm.reduct == cold.reduct
    assert warm.theta_history == cold.theta_history


# ---------------------------------------------------------------------------
# end-to-end acceptance: stream a paper dataset through the server
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("delta", DELTAS)
def test_service_streaming_matches_batch(delta):
    """First half creates the dataset, second half streams in 4 update
    batches; the final reduct equals batch ``plar_reduce`` on the full
    table (the port's byte for byte, the JAX package's within tolerance) —
    for all four measures."""
    stream, (x, d) = _shuttle()
    half = len(x) // 2
    rest = len(x) - half

    async def drive():
        async with ReductServer(device=CPU) as srv:
            await srv.submit("s", x[:half], d[:half],
                             n_dec=stream.n_dec, v_max=stream.v_max)
            r = await srv.query("s", delta=delta)
            for i in range(4):
                lo = half + i * rest // 4
                hi = half + (i + 1) * rest // 4
                await srv.update("s", x[lo:hi], d[lo:hi])
                r = await srv.query("s", delta=delta)
            return r, srv.stats.copy(), list(srv.requests)

    r, stats, reqs = asyncio.run(drive())
    full = plar_reduce(x, d, delta=delta, n_dec=stream.n_dec, v_max=stream.v_max, device=CPU)
    assert r.reduct == full.reduct
    # equal reducts over equal content (same live granules, same pow2
    # capacity) fold the same sequence → byte-identical Θ histories
    assert r.theta_history == full.theta_history
    _assert_jax(delta, r, _jax_batch(delta))
    assert stats["cold"] == 1 and stats["warm"] == 4
    assert stats["merges"] == 4
    assert all(q.warm for q in reqs[1:])


def test_server_coalesces_pending_updates():
    """k buffered update batches drain as ONE merge at the next query."""
    rng = np.random.default_rng(6)
    x, d = _table(rng, 400, 6)

    async def drive():
        async with ReductServer(device=CPU) as srv:
            await srv.submit("c", x[:100], d[:100], n_dec=2, v_max=3)
            await srv.query("c", delta="SCE")
            for lo in (100, 200, 300):
                await srv.update("c", x[lo:lo + 100], d[lo:lo + 100])
            r = await srv.query("c", delta="SCE")
            return r, srv.stats.copy(), srv.handle("c")

    r, stats, handle = asyncio.run(drive())
    assert stats["updates"] == 3
    assert stats["merges"] == 1              # coalesced into one fold
    assert stats["coalesced_batches"] == 3
    assert handle.n_updates == 1             # the handle saw one batch
    assert handle.rows_absorbed == 400
    # the coalesced merge is exact: same content and reduct as JAX's batch
    assert handle.fingerprint == j_fingerprint(j_build(x, d, n_dec=2, v_max=3))
    _assert_jax("SCE", r, j_plar(x, d, delta="SCE", n_dec=2, v_max=3))


def test_server_result_cache_and_param_keys():
    """Repeat query on unchanged content is a cache hit; params and content
    changes both miss."""
    rng = np.random.default_rng(7)
    x, d = _table(rng, 300, 6)

    async def drive():
        async with ReductServer(device=CPU) as srv:
            await srv.submit("k", x[:200], d[:200], n_dec=2, v_max=3)
            r1 = await srv.query("k", delta="SCE")
            r2 = await srv.query("k", delta="SCE")          # hit
            r3 = await srv.query("k", delta="SCE", max_features=1)  # params miss
            await srv.update("k", x[200:], d[200:])
            r4 = await srv.query("k", delta="SCE")          # content miss
            return (r1, r2, r3, r4), srv.stats.copy(), list(srv.requests)

    (r1, r2, r3, r4), stats, reqs = asyncio.run(drive())
    assert stats["queries"] == 4 and stats["cache_hits"] == 1
    assert reqs[1].cached and r2 is r1
    assert not reqs[2].cached and r3.reduct != r1.reduct
    assert not reqs[3].cached
    _assert_jax("SCE", r1, j_plar(x[:200], d[:200], delta="SCE", n_dec=2, v_max=3))


def test_server_validation_and_lifecycle():
    rng = np.random.default_rng(8)
    x, d = _table(rng, 100, 4)

    async def drive():
        async with ReductServer(device=CPU) as srv:
            await srv.submit("v", x, d, n_dec=2, v_max=3)
            with pytest.raises(ValueError, match="already exists"):
                await srv.submit("v", x, d, n_dec=2, v_max=3)
            with pytest.raises(KeyError, match="unknown dataset"):
                await srv.query("nope")
            with pytest.raises(KeyError, match="unknown dataset"):
                await srv.update("nope", x, d)
            with pytest.raises(ValueError, match="rows"):
                await srv.update("v", x, d[:-1])
            # errors inside the worker propagate to the awaiting caller
            with pytest.raises(ValueError, match="unknown mode"):
                await srv.query("v", delta="SCE", mode="sprak")
            return await srv.query("v", delta="SCE")

    r = asyncio.run(drive())
    assert r.reduct  # server still serves after a failed request

    async def no_start():
        srv = ReductServer(device=CPU)
        await srv.submit("w", x, d, n_dec=2, v_max=3)  # no queue needed
        with pytest.raises(RuntimeError, match="not started"):
            await srv.query("w")

    asyncio.run(no_start())


def test_server_concurrent_submit_same_name():
    """Concurrent same-name submits: exactly one wins, the other gets the
    documented ValueError (the name is reserved before the build awaits)."""
    rng = np.random.default_rng(9)
    x, d = _table(rng, 120, 4)

    async def drive():
        async with ReductServer(device=CPU) as srv:
            results = await asyncio.gather(
                srv.submit("dup", x[:60], d[:60], n_dec=2, v_max=3),
                srv.submit("dup", x[60:], d[60:], n_dec=2, v_max=3),
                return_exceptions=True)
            errors = [r for r in results if isinstance(r, BaseException)]
            assert len(errors) == 1 and isinstance(errors[0], ValueError)
            assert srv.handle("dup") is not None
            return await srv.query("dup", delta="SCE")

    assert asyncio.run(drive()).reduct is not None


def test_reduce_server_cli_matches_jax_cli(capsys, monkeypatch):
    """``python -m repro_torch.launch.reduce_server --device cpu`` streams a
    small shuttle table, prints that its final reduct matches batch
    ``plar_reduce``, and its final reduct, events and counters equal the
    JAX CLI's on the same flags."""
    import json
    import sys

    from repro.launch import reduce_server as j_cli
    from repro_torch.launch import reduce_server as cli

    flags = ["--dataset", "shuttle", "--rows", "4000", "--attrs", "9", "--updates", "4"]
    out = cli.main(flags + ["--device", "cpu"])
    assert "final reduct matches batch plar_reduce: True" in capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["repro.launch.reduce_server"] + flags + ["--json"])
    j_cli.main()
    jout = json.loads(capsys.readouterr().out)
    assert out["reduct_matches_batch"] and jout["reduct_matches_batch"]
    assert out["final_reduct"] == jout["final_reduct"] == jout["batch_reduct"]
    assert out["table_shape"] == jout["table_shape"] == [4000, 9]
    for e, je in zip(out["events"], jout["events"]):
        assert (e["event"], e["rows"], e["granules"], e["reduct"], e["prefix_kept"]) == (
            je["event"], je["rows"], je["granules"], je["reduct"], je["prefix_kept"])
    for k in ("warm", "cold", "merges", "engine_runs", "queries"):
        assert out["stats"][k] == jout["stats"][k], k
