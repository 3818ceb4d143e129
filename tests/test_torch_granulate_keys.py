"""The GrC build's fingerprint-key sort (repro_torch.core.granularity).

``build_granularity`` sorts rows on their fingerprint keys ``(h1, h2, d)``
alone and checks the sorted neighbours for a collision, a run of equal keys
holding two different rows; only then does it build again on the column
chain.  Held here, bit for bit, against the build as it was (every column a
sort key, :func:`_chain_build`) and against the JAX twin:

* on ordinary tables, exact and not, with input weights, invalid rows and a
  capacity above the row count, at 1, 6 and 300 columns: two sorts a build,
  no fallback;
* under a degenerate hash that gives many different rows equal keys: the
  build, the fold, the merge and the streaming build are still exact, and
  ``plar_granulate_chain_fallbacks_total`` rises once a colliding build, as
  does the ``fallbacks`` attribute of the ``reduce.granulate`` span.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import granularity as jg
from repro_torch import obs
from repro_torch.core import granularity as tg
from repro_torch.core.reduction import resolve_granularity
from repro_torch.device import host_reads

torch.set_num_threads(1)
CPU = "cpu"
FALLBACKS = obs.counter("plar_granulate_chain_fallbacks_total")


def _table(seed, n, a, vmax=3, m=3, dup=0.5):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, vmax, size=(n, a)).astype(np.int32)
    src = rng.integers(0, n, size=n)
    keep = rng.random(n) < dup
    x[keep] = x[src[keep]]
    d = rng.integers(0, m, size=n).astype(np.int32)
    d[keep] = d[src[keep]]
    return x, d


def _inputs(case, seed, n, a):
    """(x, d, w, valid, capacity) of one case, numpy; 12 codes in one column,
    so its distinct rows outnumber the degenerate hash's keys."""
    x, d = _table(seed, n, a, vmax=12 if a == 1 else 3)
    rng = np.random.default_rng(seed + 100)
    w = valid = cap = None
    if case == "weighted":
        w = rng.integers(0, 9, size=n).astype(np.int32)
        valid = rng.random(n) < 0.8
    elif case == "capacity":
        cap = 2 * n + 3
    return x, d, w, valid, cap


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


def _chain_build(x, d, *, n_dec, v_max, w=None, valid=None, exact=True, seed=0,
                 capacity=None):
    """The build as it was: every column a sort key below ``(h1, h2, d)``
    when exact, and the boundaries from a second hash of the sorted rows."""
    n, a = x.shape
    cap = capacity or n
    w = torch.ones(n, dtype=torch.int32) if w is None else w
    valid = torch.ones(n, dtype=torch.bool) if valid is None else valid
    w = torch.where(valid, w, 0)
    s = torch.tensor(tg.SENTINEL, dtype=torch.int64)
    h1 = torch.where(valid, tg.row_fingerprints(x, seed), s)
    h2 = torch.where(valid, tg.row_fingerprints(x, seed + 7919), s)
    du = torch.where(valid, d.to(torch.int64) & 0xFFFFFFFF, s)
    cols = [torch.where(valid, x[:, j].to(torch.int64) & 0xFFFFFFFF, s)
            for j in reversed(range(a))] if exact else []
    order = tg.lexsort(cols + [du, h2, h1])
    x_s, d_s, w_s, valid_s = x[order], d[order], w[order], valid[order]
    if exact:
        neq = (x_s[1:] != x_s[:-1]).any(-1) | (d_s[1:] != d_s[:-1])
    else:
        neq = torch.zeros(n - 1, dtype=torch.bool)
        for h in (tg.row_fingerprints(x_s, seed), tg.row_fingerprints(x_s, seed + 7919),
                  d_s.to(torch.int64) & 0xFFFFFFFF):
            neq |= h[1:] != h[:-1]
    b = torch.cat([torch.ones(1, dtype=torch.bool), neq]) & valid_s
    ids = torch.clamp(torch.cumsum(b.to(torch.int64), 0) - 1, 0, cap - 1)
    ids = torch.where(valid_s, ids, cap)
    num = b.sum().to(torch.int32)
    w_g = torch.zeros(cap + 1, dtype=torch.int32).index_add_(0, ids, w_s)[:cap]
    x_g = torch.zeros((cap + 1, a), dtype=torch.int32)
    x_g[ids] = x_s
    d_g = torch.zeros(cap + 1, dtype=torch.int32)
    d_g[ids] = d_s
    valid_g = torch.arange(cap) < num
    return tg.Granularity(x=x_g[:cap], d=d_g[:cap], w=torch.where(valid_g, w_g, 0),
                          valid=valid_g, num=num, n_total=w.sum().to(torch.int32),
                          n_attrs=a, n_dec=n_dec, v_max=v_max)


def _assert_equal(got, want):
    """Bit-equal granularities: ``want`` is the port's or the JAX twin's."""
    for f in ("x", "d", "w", "valid"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                      err_msg=f)
    assert int(got.num) == int(want.num)
    assert int(got.n_total) == int(want.n_total)


def _count_sorts(monkeypatch):
    calls = []
    orig = torch.sort

    def counted(*a, **k):
        calls.append(1)
        return orig(*a, **k)
    monkeypatch.setattr(torch, "sort", counted)
    return calls


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("case", ["plain", "weighted", "capacity"])
@pytest.mark.parametrize("a", [1, 6, 300])
def test_build_equals_the_chain_and_jax(monkeypatch, exact, case, a):
    n = 40 if a == 300 else 200
    x, d, w, valid, cap = _inputs(case, a + len(case), n, a)
    kw = dict(n_dec=3, v_max=int(x.max()) + 1, exact=exact, capacity=cap)
    want = jg.build_granularity(jnp.asarray(x), jnp.asarray(d), w=_j(w), valid=_j(valid), **kw)
    chain = _chain_build(torch.from_numpy(x), torch.from_numpy(d), w=_t(w), valid=_t(valid),
                         **kw)
    f0 = FALLBACKS.value
    sorts = _count_sorts(monkeypatch)
    got = tg.build_granularity(torch.from_numpy(x), torch.from_numpy(d), w=_t(w),
                               valid=_t(valid), **kw)
    monkeypatch.undo()
    assert len(sorts) == 2                        # (d), then (h1, h2) packed: not A + 3
    assert FALLBACKS.value == f0
    _assert_equal(got, want)
    _assert_equal(got, chain)
    assert 1 < int(got.num) < int(got.n_total)    # granules merged rows


@pytest.mark.parametrize("hi,lo", [(0, 0), (0, 0xFFFFFFFF), (1, 0), (0x7FFFFFFF, 5),
                                   (0x80000000, 0), (0xFFFFFFFF, 0xFFFFFFFE)])
def test_packed_key_keeps_the_unsigned_pair_order(hi, lo):
    pairs = sorted({(hi, lo), (0xFFFFFFFF, 0xFFFFFFFF), (0, 1), (0x80000000, 0xFFFFFFFF),
                    (0x7FFFFFFF, 0xFFFFFFFF), (hi, max(lo - 1, 0))})
    t = torch.tensor(pairs, dtype=torch.int64)
    packed = tg._pack(t[:, 0], t[:, 1])
    assert (packed[1:] > packed[:-1]).all()
    assert int(packed[-1]) == tg._PACKED_SENTINEL == torch.iinfo(torch.int64).max


# ---------------------------------------------------------------------------
# a degenerate hash: one bit of each fingerprint, so different rows collide
# ---------------------------------------------------------------------------


@pytest.fixture
def degenerate(monkeypatch):
    """Both packages hash with the low bit of each fingerprint; JAX's
    build runs eagerly, so the patched hash is the one it traces."""
    t_orig, j_orig = tg.row_fingerprints, jg.row_fingerprints
    monkeypatch.setattr(tg, "row_fingerprints", lambda x, seed: t_orig(x, seed) & 1)
    monkeypatch.setattr(jg, "row_fingerprints",
                        lambda x, seed: j_orig(x, seed) & jnp.uint32(1))
    monkeypatch.setattr(jg, "build_granularity", jg.build_granularity.__wrapped__)


def _counted_builds(monkeypatch):
    """The port's builds, counted through the module (the fold and the merge
    call them by that name)."""
    calls = []
    orig = tg.build_granularity

    def counted(*a, **k):
        calls.append(1)
        return orig(*a, **k)
    monkeypatch.setattr(tg, "build_granularity", counted)
    return calls


@pytest.mark.parametrize("case", ["plain", "weighted", "capacity"])
@pytest.mark.parametrize("a", [1, 6, 300])
def test_colliding_build_is_exact_and_counted(degenerate, case, a):
    n = 40 if a == 300 else 200
    x, d, w, valid, cap = _inputs(case, 7 * a + len(case), n, a)
    kw = dict(n_dec=3, v_max=int(x.max()) + 1, capacity=cap)
    want = jg.build_granularity(jnp.asarray(x), jnp.asarray(d), w=_j(w), valid=_j(valid), **kw)
    chain = _chain_build(torch.from_numpy(x), torch.from_numpy(d), w=_t(w), valid=_t(valid),
                         **kw)
    f0 = FALLBACKS.value
    got = tg.build_granularity(torch.from_numpy(x), torch.from_numpy(d), w=_t(w),
                               valid=_t(valid), **kw)
    assert FALLBACKS.value == f0 + 1
    _assert_equal(got, want)
    _assert_equal(got, chain)


def test_colliding_fold_merge_and_stream_are_exact(degenerate, monkeypatch):
    x, d = _table(21, 900, 8, vmax=4)
    builds = _counted_builds(monkeypatch)
    f0 = FALLBACKS.value
    acc = jacc = None
    for lo, hi in ((0, 300), (300, 700), (700, 900)):
        acc = tg.fold_chunk(acc, x[lo:hi], d[lo:hi], n_dec=3, v_max=4, device=CPU)
        jacc = jg.fold_chunk(jacc, x[lo:hi], d[lo:hi], n_dec=3, v_max=4)
        _assert_equal(acc, jacc)
    assert len(builds) == FALLBACKS.value - f0 >= 5   # 3 chunks, 2 merges or more

    mono = _chain_build(torch.from_numpy(x), torch.from_numpy(d), n_dec=3, v_max=4)
    live = int(acc.num)
    assert live == int(mono.num)
    for f in ("x", "d", "w"):
        np.testing.assert_array_equal(getattr(acc, f)[:live].numpy(),
                                      getattr(mono, f)[:live].numpy())

    a = tg.build_granularity(torch.from_numpy(x[:450]), torch.from_numpy(d[:450]),
                             n_dec=3, v_max=4)
    b = tg.build_granularity(torch.from_numpy(x[450:]), torch.from_numpy(d[450:]),
                             n_dec=3, v_max=4)
    ja = jg.build_granularity(jnp.asarray(x[:450]), jnp.asarray(d[:450]), n_dec=3, v_max=4)
    jb = jg.build_granularity(jnp.asarray(x[450:]), jnp.asarray(d[450:]), n_dec=3, v_max=4)
    f0, n0 = FALLBACKS.value, len(builds)
    _assert_equal(tg.merge_granularity(a, b, capacity=2), jg.merge_granularity(ja, jb, capacity=2))
    assert len(builds) - n0 == FALLBACKS.value - f0 >= 2      # capacity 2 overflows: rebuilt

    chunks = [(x[lo:lo + 256], d[lo:lo + 256]) for lo in range(0, 900, 256)]
    st = tg.build_granularity_streaming(iter(chunks), n_dec=3, v_max=4, device=CPU)
    _assert_equal(st, jg.build_granularity_streaming(iter(chunks), n_dec=3, v_max=4))
    np.testing.assert_array_equal(st.x[:live].numpy(), mono.x[:live].numpy())


@pytest.mark.parametrize("collide", [False, True])
def test_granulate_span_counts_fallbacks_and_reads(degenerate, monkeypatch, collide):
    if not collide:
        monkeypatch.undo()
    x, d = _table(5, 600, 9)
    t = obs.get_tracer()
    was = t.enabled
    t.clear()
    t.enable()
    try:
        r0, f0 = host_reads(), FALLBACKS.value
        gran = resolve_granularity(x, d, device=CPU)
        reads = host_reads() - r0
        (span,) = [r for r in t.records() if r.name == "reduce.granulate"]
    finally:
        t.clear()
        t.enabled = was
    assert span.args["fallbacks"] == FALLBACKS.value - f0 == int(collide)
    # n_dec, v_max, the collision count, the live count, with_capacity's two
    assert span.args["host_reads"] == reads == 6
    assert span.args["granules"] == int(gran.num)
    _assert_equal(gran, _chain_build(torch.from_numpy(x), torch.from_numpy(d), n_dec=3,
                                     v_max=3, capacity=gran.capacity))
