"""GrC-based initialization: the granularity representation of a decision table.

The paper (PLAR §3.3) converts the decision table ``S = (U, C ∪ D)`` into the
granularity representation ``G^(C∪D) = {(E⃗, |E|)}`` — distinct rows with
multiplicities — once, and every later evaluation of ``Θ(D|B)`` works on
granules.  This is the PyTorch port of ``repro.core.granularity``; every
function returns the same bits as its JAX twin (the tests hand both the same
numpy inputs):

* Rows are fingerprinted with a *linear* polynomial hash
  ``h(row) = Σ_j mix32(x[:, j] ⊕ seed_j) · m_j (mod 2³²)`` with two seeds.
* "unique rows" is a lexsort + adjacent-compare + segment sum.
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


def _sort_keys(x, d, valid, exact: bool, seed: int):
    """Sort keys grouping equal rows; invalid rows sort to the end."""
    sentinel = torch.tensor(SENTINEL, dtype=torch.int64, device=x.device)
    h1 = torch.where(valid, row_fingerprints(x, seed), sentinel)
    h2 = torch.where(valid, row_fingerprints(x, seed + 7919), sentinel)
    du = torch.where(valid, _as_u32(d), sentinel)
    if exact:
        # Primary: fingerprints (cheap bucketing); within buckets, the actual
        # columns break hash collisions, making the grouping collision-free.
        # Each column key is made when the sort chain reaches it: all of them
        # at once are [n, A] int64 (13 GB at sdss's 320,000 x 5,201).
        cols = (torch.where(valid, _as_u32(x[:, j]), sentinel)
                for j in reversed(range(x.shape[1])))
        keys = itertools.chain(cols, (du, h2, h1))  # last key = primary
    else:
        keys = (du, h2, h1)
    return lexsort(keys), (h1, h2, du)


def _boundaries(x_s, d_s, valid_s, hashes_s, exact: bool) -> torch.Tensor:
    if exact:
        neq = (x_s[1:] != x_s[:-1]).any(dim=-1) | (d_s[1:] != d_s[:-1])
    else:
        neq = torch.zeros(x_s.shape[0] - 1, dtype=torch.bool, device=x_s.device)
        for h in hashes_s:
            neq = neq | (h[1:] != h[:-1])
    first = torch.ones((1,), dtype=torch.bool, device=x_s.device)
    return torch.cat([first, neq]) & valid_s


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
    """
    n, n_attrs = x.shape
    dev = x.device
    cap = capacity or n
    if w is None:
        w = torch.ones((n,), dtype=torch.int32, device=dev)
    if valid is None:
        valid = torch.ones((n,), dtype=torch.bool, device=dev)
    w = torch.where(valid, w, torch.zeros_like(w))

    order, _ = _sort_keys(x, d, valid, exact, seed)
    x_s, d_s, w_s, valid_s = x[order], d[order], w[order], valid[order]
    h1s = row_fingerprints(x_s, seed)
    h2s = row_fingerprints(x_s, seed + 7919)
    b = _boundaries(x_s, d_s, valid_s, (h1s, h2s, _as_u32(d_s)), exact)

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
    )


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
