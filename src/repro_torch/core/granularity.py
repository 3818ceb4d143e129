"""GrC-based initialization: the granularity representation of a decision table.

The paper (PLAR §3.3) converts the decision table ``S = (U, C ∪ D)`` into the
granularity representation ``G^(C∪D) = {(E⃗, |E|)}`` — distinct rows with
multiplicities — once, and every later evaluation of ``Θ(D|B)`` works on
granules.  This is the PyTorch port of ``repro.core.granularity``; every
function returns the same bits as its JAX twin (the tests hand both the same
numpy inputs):

* Rows are fingerprinted with a *linear* polynomial hash
  ``h(row) = Σ_j mix32(x[:, j] ⊕ seed_j) · m_j (mod 2³²)`` with two seeds.
* "unique rows" is a lexsort + adjacent-compare + segment sum.  The sort
  keys are the two fingerprints and the decision alone; JAX also sorts on
  every column below them.  Where no run of equal keys holds two different
  rows, those column sorts all tie and the orders are equal; the build
  checks that and otherwise sorts on every column too
  (:func:`build_granularity`).
* The output table is padded to a static capacity with a validity mask;
  ``num`` carries the live granule count.

Porting traps, named where they bite:

* **uint32 arithmetic.**  PyTorch has no full uint32 arithmetic, so hashes
  live in int64 holding values in ``[0, 2³²)``.  Products are split into
  16-bit halves (:func:`_mul32`) so no int64 product can overflow, and every
  result is masked back to 32 bits.
* **lexsort.**  ``jnp.lexsort`` sorts by its *last* key first.  Here it is a
  chain of stable sorts from ``keys[0]`` to ``keys[-1]`` (:func:`lexsort`);
  total ties keep their original order in both, so granule order is equal.
* **Out-of-range indices.**  JAX drops out-of-range scatters and clamps
  out-of-range gathers; PyTorch raises (CPU) or device-asserts (CUDA).  Every
  such scatter writes into one extra slot that is sliced off, and gathers
  clamp explicitly.
"""
from __future__ import annotations

import dataclasses
import itertools
import threading
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import obs
from repro_torch.device import DeviceLike, host_int, resolve_device

__all__ = [
    "Granularity",
    "build_granularity",
    "build_granularity_streaming",
    "fold_chunk",
    "merge_granularity",
    "with_capacity",
    "next_pow2",
    "column_terms",
    "dyn_column_terms",
    "row_fingerprints",
    "chain_fallbacks",
    "regranulate",
    "pack_ids",
    "presence_bitmap",
    "ids_from_presence",
    "compact_ids",
    "project_columns",
    "granularity_from_numpy",
    "lexsort",
    "SENTINEL",
]

_GOLDEN = np.uint32(0x9E3779B9)
_MASK32 = 0xFFFFFFFF
SENTINEL = 0xFFFFFFFF  # sort key of invalid slots: after every uint32 value


def _mul32(v: torch.Tensor, c) -> torch.Tensor:
    """``(v · c) mod 2³²`` for int64 ``v`` and ``c`` in ``[0, 2³²)``.

    Split into 16-bit halves of ``c``: each partial product is below 2⁴⁸, so
    nothing overflows int64 (the uint32 hashing trap).
    """
    lo = v * (c & 0xFFFF)
    hi = ((v * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def _mix32(v: torch.Tensor) -> torch.Tensor:
    """SplitMix-style 32-bit finalizer on int64 tensors holding uint32 values."""
    v = v & _MASK32
    v = v ^ (v >> 16)
    v = _mul32(v, 0x7FEB352D)
    v = v ^ (v >> 15)
    v = _mul32(v, 0x846CA68B)
    v = v ^ (v >> 16)
    return v


def _column_seeds(n_cols: int, seed: int) -> np.ndarray:
    """Deterministic per-column (seed, multiplier) pairs, host-side."""
    idx = np.arange(n_cols, dtype=np.uint64)
    mask = np.uint64(0xFFFFFFFF)
    col_seed = (idx * np.uint64(_GOLDEN) + np.uint64(seed) * np.uint64(0x85EBCA6B)) & mask
    mult = (((col_seed ^ (col_seed >> np.uint64(13))) * np.uint64(0xC2B2AE35)) & mask) | np.uint64(1)
    return np.stack([col_seed, mult], axis=0).astype(np.int64)  # [2, n_cols]


def _as_u32(x: torch.Tensor) -> torch.Tensor:
    """int32 → int64 holding the uint32 reinterpretation (``astype(uint32)``)."""
    return x.to(torch.int64) & _MASK32


def column_terms(x_col: torch.Tensor, col_index: int, n_cols: int, seed: int) -> torch.Tensor:
    """Hash term contributed by one column: mix32(v ⊕ seed_j) · m_j  (mod 2³²).

    ``row_fingerprints(x) == Σ_j column_terms(x[:, j], j) mod 2³²`` — the
    linear-sketch property used to remove a column from a fingerprint.
    """
    seeds = _column_seeds(n_cols, seed)
    cs = int(seeds[0, col_index])
    mult = int(seeds[1, col_index])
    return _mul32(_mix32(_as_u32(x_col) ^ cs), mult)


def _device_column_seeds(n_cols: int, seed: int, device) -> torch.Tensor:
    """:func:`_column_seeds` computed on ``device`` (int64 ``[2, n_cols]``).

    The same uint32 arithmetic in int64 with 32-bit masks, from an
    ``arange``: no host table is copied to the device, so it runs inside a
    captured CUDA graph.
    """
    idx = torch.arange(n_cols, dtype=torch.int64, device=device)
    col_seed = (_mul32(idx, int(_GOLDEN)) + ((seed * 0x85EBCA6B) & _MASK32)) & _MASK32
    mult = _mul32(col_seed ^ (col_seed >> 13), 0xC2B2AE35) | 1
    return torch.stack([col_seed, mult])


def dyn_column_terms(x: torch.Tensor, col: torch.Tensor, seed: int) -> torch.Tensor:
    """:func:`column_terms` for a column index that is a tensor on ``x``'s
    device: the column and its (seed, multiplier) pair are gathered on the
    device, with no host read of ``col``."""
    col = col.reshape(1).to(torch.int64)
    seeds = _device_column_seeds(x.shape[1], seed, x.device).index_select(1, col)
    x_col = x.index_select(1, col)[:, 0]
    return _mul32(_mix32(_as_u32(x_col) ^ seeds[0]), seeds[1])


# int64 cells one hashing temporary may hold (512 MiB).  The hash of a wide
# table is summed over column blocks of this many cells: at 320,000 x 5,201
# (sdss) one unblocked temporary is 13 GB, and the mix takes several.
_HASH_BLOCK_CELLS = 1 << 26


def row_fingerprints(x: torch.Tensor, seed: int) -> torch.Tensor:
    """Linear polynomial fingerprint of each row (int64 holding a uint32).

    Summed over blocks of columns: the terms' int64 sum is exact, so the
    blocks give the unblocked sum's bits.
    """
    n_cols = x.shape[-1]
    seeds = torch.as_tensor(_column_seeds(n_cols, seed), device=x.device)
    rows = max(x.numel() // max(n_cols, 1), 1)
    step = max(1, _HASH_BLOCK_CELLS // rows)
    # each term < 2³², so the int64 column sum cannot overflow below 2³¹ columns
    acc = torch.zeros(x.shape[:-1], dtype=torch.int64, device=x.device)
    for lo in range(0, n_cols, step):
        s = seeds[:, lo:lo + step]
        acc = acc + _mul32(_mix32(_as_u32(x[..., lo:lo + step]) ^ s[0]), s[1]).sum(dim=-1)
    return acc & _MASK32


@dataclasses.dataclass
class Granularity:
    """Padded granularity representation ``G^(A)`` of a decision table.

    Attributes (all tensors on one ``device``):
      x:     [cap, A] int32 — representative feature vector of each granule.
      d:     [cap]    int32 — decision label of each granule.
      w:     [cap]    int32 — multiplicity |E| (0 for padding slots).  Kept
             int32, as in the JAX package; cast to f32 at the kernel boundary.
      valid: [cap]    bool  — slot liveness mask.
      num:   []       int32 — number of live granules G.
      n_total: []     int32 — |U| = Σ w.
    Static metadata: n_attrs, n_dec (m), v_max (max categorical code + 1).
    """

    x: torch.Tensor
    d: torch.Tensor
    w: torch.Tensor
    valid: torch.Tensor
    num: torch.Tensor
    n_total: torch.Tensor
    n_attrs: int
    n_dec: int
    v_max: int

    @property
    def capacity(self) -> int:
        return self.x.shape[0]

    @property
    def device(self) -> torch.device:
        return self.x.device

    def to(self, device: DeviceLike) -> "Granularity":
        """The same granularity with every tensor on ``device``."""
        dev = torch.device(device)
        if dev == self.device:
            return self
        return dataclasses.replace(
            self, **{f: getattr(self, f).to(dev)
                     for f in ("x", "d", "w", "valid", "num", "n_total")})


def granularity_from_numpy(x, d, w, valid, num, n_total, *, n_attrs: int,
                           n_dec: int, v_max: int,
                           device: DeviceLike = "cuda") -> Granularity:
    """Carry a granularity across from numpy arrays (e.g. the JAX package's).

    The state-conversion step of the port: hand the identical granularity to
    both packages and compare everything downstream.
    """
    dev = resolve_device(device)
    return Granularity(
        x=torch.tensor(np.asarray(x, np.int32), device=dev),
        d=torch.tensor(np.asarray(d, np.int32), device=dev),
        w=torch.tensor(np.asarray(w, np.int32), device=dev),
        valid=torch.tensor(np.asarray(valid, bool), device=dev),
        num=torch.tensor(int(num), dtype=torch.int32, device=dev),
        n_total=torch.tensor(int(n_total), dtype=torch.int32, device=dev),
        n_attrs=int(n_attrs), n_dec=int(n_dec), v_max=int(v_max),
    )


def lexsort(keys: Sequence[torch.Tensor]) -> torch.Tensor:
    """``jnp.lexsort`` semantics: ``keys[-1]`` is the primary key.

    A chain of stable sorts from the least significant key to the most
    significant; rows equal on every key keep their input order, as in JAX.
    Keys are int64 (uint32 values and the 0xFFFFFFFF sentinel sort right).
    """
    order = None
    for k in keys:
        k = k.to(torch.int64)
        if order is None:
            order = torch.sort(k, stable=True).indices
        else:
            order = order[torch.sort(k[order], stable=True).indices]
    return order


def _pack(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """One int64 key whose order is the unsigned order of the uint32 pair
    ``(hi, lo)``: ``hi`` is biased into the signed range, so nothing overflows.
    """
    return (hi - (1 << 31)) * (1 << 32) + lo


# the packed key of an invalid slot, (SENTINEL, SENTINEL): the int64 maximum
_PACKED_SENTINEL = (SENTINEL - (1 << 31)) * (1 << 32) + SENTINEL


def _key_order(x, d, valid, seed: int):
    """Order rows on the fingerprint keys alone: ``(h1, h2, d)``, invalid rows
    last, in two stable sorts (``h1`` and ``h2`` packed into one key).

    Returns the order and the sorted raw keys ``(h1, h2)`` packed and ``d``;
    each row is hashed once.  Equal rows have equal keys, so equal (row,
    decision) pairs are neighbours; whether a run of equal keys holds two
    different rows is checked after the gather (:func:`build_granularity`).
    """
    hp = _pack(row_fingerprints(x, seed), row_fingerprints(x, seed + 7919))
    du = _as_u32(d)
    order = lexsort((torch.where(valid, du, SENTINEL),
                     torch.where(valid, hp, _PACKED_SENTINEL)))
    return order, hp[order], du[order]


def _chain_order(x, d, valid, seed: int):
    """The column chain's order: ``(h1, h2, d)`` first, then every column
    breaks what the fingerprints tie, so no run of equal keys holds two
    different rows whatever the hash gives; invalid rows last.
    """
    sentinel = torch.tensor(SENTINEL, dtype=torch.int64, device=x.device)
    h1 = torch.where(valid, row_fingerprints(x, seed), sentinel)
    h2 = torch.where(valid, row_fingerprints(x, seed + 7919), sentinel)
    du = torch.where(valid, _as_u32(d), sentinel)
    # Each column key is made when the sort chain reaches it: all of them
    # at once are [n, A] int64 (13 GB at sdss's 320,000 x 5,201).
    cols = (torch.where(valid, _as_u32(x[:, j]), sentinel)
            for j in reversed(range(x.shape[1])))
    return lexsort(itertools.chain(cols, (du, h2, h1)))  # last key = primary


def _neighbours_differ(*cols: torch.Tensor) -> torch.Tensor:
    """bool [n-1]: row i+1 differs from row i in some of ``cols``."""
    neq = torch.zeros(max(cols[0].shape[0] - 1, 0), dtype=torch.bool, device=cols[0].device)
    for c in cols:
        c = c[1:] != c[:-1]
        neq = neq | (c.any(dim=-1) if c.dim() > 1 else c)
    return neq


# Builds made again on the column chain: in the process registry, and per
# thread for the ``fallbacks`` attribute of the ``reduce.granulate`` span.
_CHAIN_FALLBACKS = obs.counter(
    "plar_granulate_chain_fallbacks_total",
    "GrC builds whose fingerprint keys grouped two different rows, made again on the column chain")


class _Fallbacks(threading.local):
    n = 0


_FALLBACKS = _Fallbacks()


def chain_fallbacks() -> int:
    """The builds this thread has made again on the column chain."""
    return _FALLBACKS.n


def build_granularity(
    x: torch.Tensor,
    d: torch.Tensor,
    *,
    n_dec: int,
    v_max: int,
    w: Optional[torch.Tensor] = None,
    valid: Optional[torch.Tensor] = None,
    exact: bool = True,
    seed: int = 0,
    capacity: Optional[int] = None,
) -> Granularity:
    """GrC initialization: build ``G^(C∪D)`` from (possibly pre-weighted) rows.

    Runs on ``x``'s device.  Accepting input weights makes this the merge
    step of the streaming build too (re-granulating a concatenation of
    granule tables merges duplicate keys exactly).

    Rows are sorted on their fingerprint keys alone.  ``exact`` then counts
    the neighbours whose keys are equal and whose rows or decisions are not,
    and reads the count once, after the whole build is queued.  With none,
    each run of equal keys is one distinct row, the column chain's sorts
    would all tie inside it, and its order is this one: the granules are the
    chain's bit for bit.  With any, the build is made again on the column
    chain (:func:`_chain_order`) and ``plar_granulate_chain_fallbacks_total``
    rises.
    """
    n = x.shape[0]
    cap = capacity or n
    if w is None:
        w = torch.ones((n,), dtype=torch.int32, device=x.device)
    if valid is None:
        valid = torch.ones((n,), dtype=torch.bool, device=x.device)
    w = torch.where(valid, w, torch.zeros_like(w))

    order, hp_s, du_s = _key_order(x, d, valid, seed)
    valid_s = valid[order]
    if exact:
        # the sort's own keys: every invalid slot holds the sentinel
        hp_s = torch.where(valid_s, hp_s, _PACKED_SENTINEL)
        du_s = torch.where(valid_s, du_s, SENTINEL)
    key_neq = _neighbours_differ(hp_s, du_s)
    del hp_s, du_s               # gone before the rows are gathered
    g, collisions = _granulate(x, d, w, order, valid_s, key_neq, exact,
                               n_dec=n_dec, v_max=v_max, cap=cap)
    if exact and host_int(collisions):
        del g, order, valid_s, key_neq       # freed before the chain's build
        _CHAIN_FALLBACKS.inc()
        _FALLBACKS.n += 1
        order = _chain_order(x, d, valid, seed)
        g, _ = _granulate(x, d, w, order, valid[order], None, True,
                          n_dec=n_dec, v_max=v_max, cap=cap)
    return g


def _granulate(x, d, w, order, valid_s, key_neq, exact: bool, *,
               n_dec: int, v_max: int, cap: int):
    """The granules of the rows taken in ``order``.

    Boundaries are where rows or decisions change (``exact``) or where the
    keys change (``key_neq``).  Returns the granularity and, when ``exact``
    and ``key_neq`` are given, the count of neighbours with equal keys and
    different rows (a device scalar; a valid row beside an invalid one
    counts), else ``None``.
    """
    n_attrs = x.shape[1]
    dev = x.device
    x_s, d_s, w_s = x[order], d[order], w[order]
    collisions = None
    if exact:
        neq = _neighbours_differ(x_s, d_s)
        if key_neq is not None:
            both = valid_s[1:] & valid_s[:-1]
            differ = torch.where(both, neq, valid_s[1:] ^ valid_s[:-1])
            collisions = (differ & ~key_neq).sum()
    else:
        neq = key_neq
    b = torch.cat([torch.ones((1,), dtype=torch.bool, device=dev), neq]) & valid_s

    ids = torch.cumsum(b.to(torch.int64), dim=0) - 1
    # clip, as JAX does: on overflow (num > cap) valid rows pile into cap-1 and
    # merge_granularity detects the overflow from num and rebuilds larger
    ids = torch.clamp(ids, 0, cap - 1)
    num = b.sum().to(torch.int32)

    # Invalid (padding) rows go to the extra slot ``cap`` and are sliced off —
    # JAX's dropped out-of-bounds scatter.  They must never land in a live
    # segment, where their zero rows would overwrite its representative.
    ids_w = torch.where(valid_s, ids, torch.full_like(ids, cap))
    w_g = torch.zeros((cap + 1,), dtype=w.dtype, device=dev).index_add_(0, ids_w, w_s)[:cap]
    # Representative rows: every row in a segment shares the key, any write wins.
    x_g = torch.zeros((cap + 1, n_attrs), dtype=x.dtype, device=dev)
    x_g[ids_w] = x_s
    d_g = torch.zeros((cap + 1,), dtype=d.dtype, device=dev)
    d_g[ids_w] = d_s
    valid_g = torch.arange(cap, device=dev) < num

    return Granularity(
        x=x_g[:cap],
        d=d_g[:cap],
        w=torch.where(valid_g, w_g, torch.zeros_like(w_g)),
        valid=valid_g,
        num=num,
        n_total=w.sum().to(torch.int32),
        n_attrs=n_attrs,
        n_dec=n_dec,
        v_max=v_max,
    ), collisions


def next_pow2(v: int) -> int:
    """Smallest power of two ≥ v (1 for v ≤ 1)."""
    return 1 << max(0, (int(v) - 1)).bit_length()


def with_capacity(gran: Granularity, capacity: int) -> Granularity:
    """Re-pad a *front-packed* granularity (live slots first, the layout
    :func:`build_granularity` emits) to a new static capacity.

    Shrinking below the live count would silently drop granules, so it
    raises; growing appends zero-weight padding.
    """
    cap = gran.capacity
    if capacity == cap:
        return gran
    if capacity < cap:
        num = host_int(gran.num)
        if num > capacity:
            raise ValueError(
                f"capacity {capacity} < live granule count {num}")
        if host_int(gran.valid[:capacity].sum()) != num:
            raise ValueError(
                "granularity is not front-packed: live slots extend past the "
                f"requested capacity {capacity}")
        x = gran.x[:capacity]
        d = gran.d[:capacity]
        w = gran.w[:capacity]
        valid = gran.valid[:capacity]
    else:
        pad = capacity - cap
        dev = gran.device
        x = torch.cat([gran.x, torch.zeros((pad, gran.n_attrs), dtype=gran.x.dtype, device=dev)])
        d = torch.cat([gran.d, torch.zeros((pad,), dtype=gran.d.dtype, device=dev)])
        w = torch.cat([gran.w, torch.zeros((pad,), dtype=gran.w.dtype, device=dev)])
        valid = torch.cat([gran.valid, torch.zeros((pad,), dtype=torch.bool, device=dev)])
    return dataclasses.replace(gran, x=x, d=d, w=w, valid=valid)


def merge_granularity(a: Granularity, b: Granularity, *, exact: bool = True,
                      seed: int = 0, capacity: Optional[int] = None) -> Granularity:
    """Monoid merge: ``G^(A∪B) = G^(A) ⊕ G^(B)`` — the chunked reduceByKey.

    Concatenates the two padded tables and re-granulates with the input
    weights, so duplicate keys across the operands merge weight-additively;
    the live prefix of the result is the globally sorted distinct-key table.
    The capacity starts at ``next_pow2(max(capacity, a.capacity,
    b.capacity))`` and is rebuilt at ``next_pow2(num)`` whenever the live
    keys overflow it (``num`` counts boundaries before the clip).
    """
    if (a.n_attrs, a.n_dec, a.v_max) != (b.n_attrs, b.n_dec, b.v_max):
        raise ValueError(
            "merge_granularity operands disagree on static metadata: "
            f"{(a.n_attrs, a.n_dec, a.v_max)} vs {(b.n_attrs, b.n_dec, b.v_max)}")
    x = torch.cat([a.x, b.x])
    d = torch.cat([a.d, b.d])
    w = torch.cat([a.w, b.w])
    valid = torch.cat([a.valid, b.valid])
    cap = next_pow2(max(capacity or 1, a.capacity, b.capacity))
    while True:
        g = build_granularity(
            x, d, n_dec=a.n_dec, v_max=a.v_max, w=w, valid=valid,
            exact=exact, seed=seed, capacity=cap,
        )
        num = host_int(g.num)
        if num <= cap:
            return g
        cap = next_pow2(num)


def build_granularity_streaming(
    chunks,
    *,
    n_dec: int,
    v_max: int,
    exact: bool = True,
    seed: int = 0,
    device: DeviceLike = "cuda",
) -> Granularity:
    """GrC initialization without the whole table: fold :func:`merge_granularity`
    over an iterable of ``(x, d)`` numpy row chunks, each moved to ``device``.

    The live prefix of the result is element-wise identical to a monolithic
    :func:`build_granularity` over the concatenated rows (only the padded
    capacity may differ).
    """
    dev = resolve_device(device)
    acc: Optional[Granularity] = None
    for xc, dc in chunks:
        acc = fold_chunk(acc, xc, dc, n_dec=n_dec, v_max=v_max, exact=exact,
                         seed=seed, device=dev)
    if acc is None:
        raise ValueError("build_granularity_streaming: no non-empty chunks")
    return acc


def fold_chunk(acc: Optional[Granularity], xc, dc, *, n_dec: int, v_max: int,
               exact: bool = True, seed: int = 0,
               device: DeviceLike = "cuda") -> Optional[Granularity]:
    """One step of the streaming fold: granulate a row chunk and merge it.

    Both operands shrink to their live counts (next pow2) before the merge,
    so the merge sort pays for live keys, not padding.
    """
    dev = resolve_device(device)
    xc = torch.as_tensor(np.asarray(xc, np.int32), device=dev)
    dc = torch.as_tensor(np.asarray(dc, np.int32), device=dev)
    if xc.shape[0] == 0:
        return acc
    with obs.span("pipeline.fold_chunk", rows=int(xc.shape[0]),
                  fresh=acc is None) as sp:
        g = build_granularity(
            xc, dc, n_dec=n_dec, v_max=v_max, exact=exact, seed=seed,
            capacity=next_pow2(xc.shape[0]),
        )
        num = host_int(g.num)
        g = with_capacity(g, next_pow2(max(num, 1)))
        if acc is not None:
            g = merge_granularity(acc, g, exact=exact, seed=seed)
            num = host_int(g.num)
            g = with_capacity(g, next_pow2(max(num, 1)))
        sp.set(granules=num)      # the count read above: no read of its own
    return g


def regranulate(gran: Granularity, cols, *, exact: bool = True, seed: int = 0) -> Granularity:
    """Coarsen ``G^(C∪D)`` onto the column subset ``cols`` (Corollary 3.3)."""
    cols = torch.as_tensor(cols, dtype=torch.int64, device=gran.device)
    return build_granularity(
        gran.x[:, cols], gran.d, n_dec=gran.n_dec, v_max=gran.v_max,
        w=gran.w, valid=gran.valid, exact=exact, seed=seed,
        capacity=gran.capacity,
    )


def project_columns(gran: Granularity, cols: Sequence[int]) -> Granularity:
    """Alias of :func:`regranulate` taking a Python column list."""
    return regranulate(gran, list(cols))


def pack_ids(r_ids: torch.Tensor, x_col: torch.Tensor, v_max: int) -> torch.Tensor:
    """Refine class ids with one attribute: ``p = r·V + v``  (Corollary 3.4)."""
    return r_ids * v_max + x_col


def presence_bitmap(p: torch.Tensor, valid: torch.Tensor, n_bins: int) -> torch.Tensor:
    """0/1 bitmap of which packed ids occur among valid slots (int32 [n_bins])."""
    p_safe = torch.where(valid, p, torch.zeros_like(p)).to(torch.int64)
    # JAX drops out-of-range scatters: route them to an extra slot, slice it off
    p_safe = torch.where((p_safe >= 0) & (p_safe < n_bins), p_safe,
                         torch.full_like(p_safe, n_bins))
    out = torch.zeros((n_bins + 1,), dtype=torch.int32, device=p.device)
    out.scatter_reduce_(0, p_safe, valid.to(torch.int32), reduce="amax")
    return out[:n_bins]


def ids_from_presence(presence: torch.Tensor, p: torch.Tensor, valid: torch.Tensor):
    """Dense renumbering given a presence bitmap."""
    presence = (presence > 0).to(torch.int32)
    rank = (torch.cumsum(presence, dim=0, dtype=torch.int32) - presence)  # exclusive
    p_safe = torch.where(valid, p, torch.zeros_like(p)).to(torch.int64)
    # JAX clamps out-of-range gathers
    p_safe = torch.clamp(p_safe, 0, presence.shape[0] - 1)
    new_ids = torch.where(valid, rank[p_safe], torch.zeros_like(p))
    return new_ids.to(torch.int32), presence.sum().to(torch.int32)


def compact_ids(p: torch.Tensor, valid: torch.Tensor, n_bins: int):
    """Renumber sparse packed ids to dense ``[0, K_new)`` via presence bitmap.

    Sort-free: presence = scatter-max of validity, rank = cumsum.
    """
    presence = presence_bitmap(p, valid, n_bins)
    new_ids, k_new = ids_from_presence(presence, p, valid)
    return new_ids, k_new, presence
