"""Plain PyTorch versions of the three contingency kernels.

Each is the defining semantics of its CUDA kernel, and the only thing its
wrapper in :mod:`.ops` runs for a tensor on the CPU.  ``chip_smoke.py`` and
``tests/test_torch_cuda.py`` hold every kernel against these on the card.

* :func:`contingency_ref` — a scatter-add (``index_put_`` with
  ``accumulate=True``) of integer-valued f32 weights: exact below 2²⁴, so
  the kernel's atomics must match it bit for bit.
* :func:`fused_theta_ref` / :func:`sweep_theta_ref` — the materialized
  contingency, then :func:`repro_torch.core.plan.theta_tiled_raw`: θ' summed
  within each 256-bin tile, the tile partials added in ascending order — the
  kernels' own order, so Θ_PR is bit-equal and the other measures differ
  only by the order of the within-tile sum.
* :func:`tile_segments` / :func:`sweep_theta_segments_ref` — the plain
  version of the sweep kernel's schedule: live granules ordered by the tile
  bucket of their class, each 256-bin tile reading only the segment of the
  classes it holds.  Its
  Θ is the same bits as :func:`sweep_theta_ref`'s, since every tile's
  contingency is the same integer-valued f32 counts.
* :func:`candidate_segments` / :func:`fused_theta_segments_ref` — the plain
  version of the fused kernel's schedule: each candidate's live keys ordered
  by their 256-bin tile, tile t of candidate c reading only segment (c, t).
  Its Θ is the same bits as :func:`fused_theta_ref`'s, for the same reason.
"""
from __future__ import annotations

import torch

from repro_torch.core import measures
from repro_torch.core.plan import LADDER_TILE, theta_tiled_raw

__all__ = ["candidate_segments", "contingency_ref", "fused_theta_raw_ref", "fused_theta_ref",
           "fused_theta_segments_ref", "sweep_theta_ref", "sweep_theta_segments_ref",
           "tile_segments"]


def contingency_ref(
    packed: torch.Tensor,  # [nc, G] int32, values in [0, n_bins) (others dropped)
    d: torch.Tensor,       # [G]    int32, values in [0, n_dec)
    w: torch.Tensor,       # [G]    float32 (0 for padding granules)
    *,
    n_bins: int,
    n_dec: int,
) -> torch.Tensor:
    """counts[c, k, j] = Σ_g w_g · 1[packed[c,g] = k] · 1[d_g = j]."""
    nc, g = packed.shape
    p = packed.to(torch.int64)
    dd = d.to(torch.int64).expand(nc, g)
    keep = (p >= 0) & (p < n_bins) & (dd >= 0) & (dd < n_dec)
    c_idx = torch.arange(nc, device=packed.device)[:, None].expand(nc, g)
    out = torch.zeros((nc, n_bins, n_dec), dtype=torch.float32, device=packed.device)
    out.index_put_((c_idx[keep], p[keep], dd[keep]),
                   w.to(torch.float32).expand(nc, g)[keep], accumulate=True)
    return out


def fused_theta_raw_ref(
    packed: torch.Tensor,  # [nc, G] int32
    d: torch.Tensor,       # [G]    int32
    w: torch.Tensor,       # [G]    float32 (0 for padding granules)
    *,
    delta: str,
    n_bins: int,
    n_dec: int,
) -> torch.Tensor:
    """Unnormalized Θ'[c]: contingency, then the tile-ordered θ' epilogue
    (the JAX package's ``plan._theta_fused_xla_raw``)."""
    cont = contingency_ref(packed, d, w, n_bins=n_bins, n_dec=n_dec)
    return theta_tiled_raw(delta, cont, tile=LADDER_TILE)


def fused_theta_ref(
    packed: torch.Tensor,  # [nc, G] int32
    d: torch.Tensor,       # [G]    int32
    w: torch.Tensor,       # [G]    float32 (0 for padding granules)
    n,                     # |U|
    *,
    delta: str,
    n_bins: int,
    n_dec: int,
) -> torch.Tensor:
    """Θ(D|B∪{a})[c]: :func:`fused_theta_raw_ref`, then the measure's one scale."""
    return measures.theta_scale(
        delta, fused_theta_raw_ref(packed, d, w, delta=delta, n_bins=n_bins, n_dec=n_dec), n)


def sweep_theta_ref(
    x_t: torch.Tensor,      # [nc, G] int32 — pre-transposed candidate slab
    r_ids: torch.Tensor,    # [G]     int32 — shared class ids of U/R (-1: padding)
    d: torch.Tensor,        # [G]     int32
    w: torch.Tensor,        # [G]   float32 (0 for padding granules)
    n,                      # |U|
    *,
    delta: str,
    v_max: int,
    n_bins: int,
    n_dec: int,
) -> torch.Tensor:
    """Pack explicitly (``p = r·V + v``), then :func:`fused_theta_ref`."""
    packed = r_ids[None, :] * v_max + x_t
    return fused_theta_ref(packed, d, w, n, delta=delta, n_bins=n_bins, n_dec=n_dec)


def tile_segments(
    r_ids: torch.Tensor,  # [G] int32 — class ids (-1: padding)
    d: torch.Tensor,      # [G] int32
    w: torch.Tensor,      # [G] float32
    *,
    v_max: int,
    n_bins: int,
    n_dec: int,
):
    """The sweep kernel's ordering: ``(perm, start, seg_begin, seg_end)``.

    ``perm`` lists the live granules (w ≠ 0, class r in
    ``[0, ceil(n_bins / V))``, d in ``[0, n_dec)``) ordered, stably, by the
    bucket of their class: ``2·⌊rV/256⌋ + s`` with ``s = 1`` when the class's
    keys ``[rV, rV + V)`` run into the next 256-bin tile.  Bucket k holds
    ``perm[start[k]:start[k + 1]]``.  Tile t's segment is the buckets
    ``2(t − S) + 1 … 2t + 1`` (``S = ⌈V/256⌉``, clamped at 0), that is
    ``perm[seg_begin[t]:seg_end[t]]``: for V ≤ 256 exactly the granules whose
    class has a key in the tile — a class straddling two tiles is in both
    segments — and for V > 256 those and some of the classes before.  Keys
    p = r·V + x with x in ``[0, V)`` stay in their class's range, so a
    tile's segment holds every granule whose key it owns.
    """
    n_cls = -(-n_bins // v_max)
    n_tiles = -(-n_bins // LADDER_TILE)
    span = -(-v_max // LADDER_TILE)
    r = r_ids.to(torch.int64)
    live = (r >= 0) & (r < n_cls) & (d >= 0) & (d < n_dec) & (w != 0)
    first = r * v_max // LADDER_TILE
    straddles = (r * v_max + v_max - 1) // LADDER_TILE > first
    key = torch.where(live, 2 * first + straddles, torch.full_like(r, 2 * n_tiles))
    order = torch.sort(key, stable=True).indices
    perm = order[:int(live.sum())]
    start = torch.searchsorted(key[perm], torch.arange(2 * n_tiles + 1, device=r.device))
    t = torch.arange(n_tiles, device=r.device)
    return perm, start, start[torch.clamp(2 * (t - span) + 1, min=0)], start[2 * t + 2]


def sweep_theta_segments_ref(
    x_t: torch.Tensor,      # [nc, G] int32, values in [0, v_max)
    r_ids: torch.Tensor,    # [G]     int32 (-1: padding)
    d: torch.Tensor,        # [G]     int32
    w: torch.Tensor,        # [G]   float32 (0 for padding granules)
    n,                      # |U|
    *,
    delta: str,
    v_max: int,
    n_bins: int,
    n_dec: int,
) -> torch.Tensor:
    """Θ through the kernel's schedule: each tile's contingency is built from
    its own segment only (an empty tile builds none), then the same
    tile-ordered θ' epilogue as :func:`fused_theta_ref`."""
    nc = x_t.shape[0]
    perm, _, seg_begin, seg_end = tile_segments(r_ids, d, w, v_max=v_max,
                                                n_bins=n_bins, n_dec=n_dec)
    cont = torch.zeros((nc, n_bins, n_dec), dtype=torch.float32, device=x_t.device)
    c_idx = torch.arange(nc, device=x_t.device)[:, None]
    for t, (b, e) in enumerate(zip(seg_begin.tolist(), seg_end.tolist())):
        if b == e:
            continue
        lo, hi = t * LADDER_TILE, min((t + 1) * LADDER_TILE, n_bins)
        g = perm[b:e]
        p = r_ids[g].to(torch.int64)[None, :] * v_max + x_t[:, g].to(torch.int64)
        keep = (p >= lo) & (p < hi)
        dd = d[g].to(torch.int64)[None, :].expand_as(p)
        ww = w[g].to(torch.float32)[None, :].expand_as(p)
        cont.index_put_((c_idx.expand_as(p)[keep], p[keep], dd[keep]), ww[keep],
                        accumulate=True)
    return measures.theta_scale(delta, theta_tiled_raw(delta, cont, tile=LADDER_TILE), n)


def candidate_segments(
    packed: torch.Tensor,  # [nc, G] int32 — any keys
    d: torch.Tensor,       # [G] int32
    w: torch.Tensor,       # [G] float32
    *,
    n_bins: int,
    n_dec: int,
):
    """The fused kernel's ordering: ``(cand, gran, start)``.

    The live pairs (c, g) — key p = packed[c, g] in ``[0, n_bins)``, d_g in
    ``[0, n_dec)``, w_g ≠ 0 — ordered, stably, by the bucket
    ``c·n_tiles + p // 256`` (a counting sort over nc × n_tiles buckets);
    entry i is candidate ``cand[i]``'s granule ``gran[i]``.  Segment (c, t),
    the keys of candidate c in tile t and nothing else, is the entries
    ``start[c·n_tiles + t] : start[c·n_tiles + t + 1]``.  Negative sentinels,
    keys at or past ``n_bins``, w = 0 and d outside ``[0, n_dec)`` are in no
    segment, as :func:`contingency_ref` drops them.
    """
    nc, g = packed.shape
    n_tiles = -(-n_bins // LADDER_TILE)
    p = packed.to(torch.int64)
    dd = d.to(torch.int64)[None, :]
    live = (p >= 0) & (p < n_bins) & (dd >= 0) & (dd < n_dec) & (w != 0)[None, :]
    c_idx = torch.arange(nc, device=packed.device)[:, None]
    key = torch.where(live, c_idx * n_tiles + p // LADDER_TILE,
                      torch.full_like(p, nc * n_tiles)).reshape(-1)
    order = torch.sort(key, stable=True).indices[:int(live.sum())]
    start = torch.searchsorted(key[order], torch.arange(nc * n_tiles + 1, device=p.device))
    return order // g, order % g, start


def fused_theta_segments_ref(
    packed: torch.Tensor,  # [nc, G] int32
    d: torch.Tensor,       # [G]    int32
    w: torch.Tensor,       # [G]    float32 (0 for padding granules)
    n,                     # |U|
    *,
    delta: str,
    n_bins: int,
    n_dec: int,
) -> torch.Tensor:
    """Θ through the fused kernel's schedule: each (candidate, tile)
    contingency is built from its own segment only (an empty segment builds
    none), then the same tile-ordered θ' epilogue as :func:`fused_theta_ref`."""
    nc = packed.shape[0]
    n_tiles = -(-n_bins // LADDER_TILE)
    cand, gran, start = candidate_segments(packed, d, w, n_bins=n_bins, n_dec=n_dec)
    cont = torch.zeros((nc, n_bins, n_dec), dtype=torch.float32, device=packed.device)
    bounds = start.tolist()
    for s in range(nc * n_tiles):
        b, e = bounds[s], bounds[s + 1]
        if b == e:
            continue
        c, g = s // n_tiles, gran[b:e]
        cont[c].index_put_((packed[c, g].to(torch.int64), d[g].to(torch.int64)),
                           w[g].to(torch.float32), accumulate=True)
    return measures.theta_scale(delta, theta_tiled_raw(delta, cont, tile=LADDER_TILE), n)
