"""Evaluation planning: how Θ(D|B) gets computed for batches of candidates.

The PyTorch port of ``repro.core.plan``.  Two modes:

* ``spark`` — the direct transliteration of PLAR Algorithm 2: each candidate
  re-keys every granule from scratch and groups by sorted key.
* ``incremental`` — exact class ids of ``U/R`` are maintained across
  iterations, so evaluating ``R ∪ {a}`` is a pack (``r·V + v``) followed by a
  contingency reduction into ``K·V`` exact bins.

Backends keep the JAX package's names, so one parameter list drives both
packages; :data:`BACKENDS` holds what the drivers need to know of each, and
every backend tuple of the core is read from it:

* ``segment`` / ``onehot`` — plain PyTorch (a scatter-add, a chunked one-hot
  contraction): the JAX package computes these in XLA, not in Pallas.  On
  a CUDA operand ``segment`` evaluates candidates through the fused kernel
  below (its ``Backend.card``), never the dense ``[nc, n_bins, m]``
  contingency; on the CPU it keeps the JAX package's arithmetic.
* ``pallas`` — the hand-written CUDA contingency kernel
  (``kernels/contingency/ops.contingency``); the name is the JAX package's.
* ``fused`` — the CUDA fused contingency→Θ kernel (``ops.fused_theta``):
  the ``[nc, K, m]`` contingency never reaches device memory.
* ``fused_xla`` — its plain-PyTorch twin (materialize, then the
  tile-ordered θ epilogue).
* ``sweep`` — the CUDA sweep kernel (``ops.sweep_theta``): read-once slab
  operands ``x_t [nc, G]`` + ``r_ids [G]``, the pack ``p = r·V + v`` done in
  the kernel.  The hot loop of the host driver.
* ``sweep_xla`` — its plain-PyTorch twin.

On a CPU tensor the kernel backends run their kernels' plain versions; on a
CUDA tensor they launch the kernel or raise.

The **bin ladder** (:func:`ladder_rungs`) supplies the bucket sizes the
driver selects from per iteration: pow2 multiples of the 256-bin tile up to
the run's bound ``cap·v_max``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from . import measures
from .granularity import SENTINEL, Granularity, lexsort, row_fingerprints

__all__ = [
    "ids_by_sort",
    "subset_ids",
    "candidate_contingency",
    "candidate_theta",
    "contingency_from_ids",
    "theta_for_ids",
    "ladder_rungs",
    "rung_for",
    "sweep_contingency",
    "theta_tiled_raw",
    "LADDER_TILE",
    "BACKENDS",
    "DEVICE_BACKENDS",
    "ENSEMBLE_BACKENDS",
    "KERNEL_BACKENDS",
    "MESH_BACKENDS",
    "SWEEP_BACKENDS",
    "SELECTOR_MODES",
    "card_kernel",
    "check_backend",
    "check_card_shape",
    "check_engine",
    "check_mode",
    "check_selector",
    "check_stacked",
]

# Bin-tile width of the ladder/sweep schedules (DESIGN.md §5.3), and the
# tile of the CUDA Θ kernels' per-tile partials: kernel and plain version
# are tile-for-tile alike.
LADDER_TILE = 256

# Tile/rung selection modes, the drivers' and the kernels' alike
# (``kernels/contingency/autotune`` imports them from here).  The selector
# picks the CUDA kernels' launch shapes and, with ``analytic``, prunes the
# ladder.
SELECTOR_MODES = ("heuristic", "analytic", "pinned")


class Backend(NamedTuple):
    """What the drivers know of a Θ backend."""

    kernel: Optional[str]  # the CUDA kernel it launches (autotune's name), or None
    slab: bool             # takes slab operands x_t [nc, G] + r_ids, not packed ids
    device: bool           # engine="auto" runs it on the device engine (JAX's rule)
    stacked: bool          # may ride the stacked engine: its measure splits off the contingency
    mesh: bool             # the mesh drivers evaluate it
    card: Optional[str] = None  # the CUDA kernel a plain backend's candidates take on the card


BACKENDS = {
    "segment": Backend(None, slab=False, device=True, stacked=True, mesh=True, card="fused"),
    "onehot": Backend(None, slab=False, device=True, stacked=True, mesh=False),
    "pallas": Backend("contingency", slab=False, device=False, stacked=False, mesh=False),
    "fused": Backend("fused", slab=False, device=False, stacked=False, mesh=False),
    "fused_xla": Backend(None, slab=False, device=True, stacked=False, mesh=False),
    "sweep": Backend("sweep", slab=True, device=False, stacked=False, mesh=False),
    "sweep_xla": Backend(None, slab=True, device=True, stacked=True, mesh=True),
}
_THETA_BACKENDS = tuple(BACKENDS)
SWEEP_BACKENDS = tuple(b for b, e in BACKENDS.items() if e.slab)
DEVICE_BACKENDS = tuple(b for b, e in BACKENDS.items() if e.device)
KERNEL_BACKENDS = {b: e.kernel for b, e in BACKENDS.items() if e.kernel}
ENSEMBLE_BACKENDS = tuple(b for b, e in BACKENDS.items() if e.stacked)
MESH_BACKENDS = tuple(b for b, e in BACKENDS.items() if e.mesh)
MODES = ("incremental", "spark")
ENGINES = ("auto", "host", "device")


def card_kernel(backend: str, device=None) -> Optional[str]:
    """The CUDA kernel a candidate evaluation on ``backend`` launches for
    ``device`` (autotune's name), or ``None``: a kernel backend's on any
    device, a plain backend's ``card`` kernel on a CUDA device only."""
    entry = BACKENDS[backend]
    on_card = device is not None and torch.device(device).type == "cuda"
    return entry.kernel or (entry.card if on_card else None)


def check_card_shape(backend: str, mode: str, device, *, n_attrs: int, cap: int, m: int,
                     mp_chunk: int) -> None:
    """Raise, before any launch or capture, where the fused kernel that
    ``backend``'s candidates take on a CUDA ``device`` (:func:`card_kernel`)
    cannot take a chunk of ``min(mp_chunk, n_attrs)`` candidates over
    ``cap`` granule slots and ``m`` decisions (``ops.check_fused_shape``).

    ``segment`` ran such tables on the card through its dense contingency
    before it took the kernel there; it has no fallback to it now.  Spark
    mode evaluates no candidate through the kernel.
    """
    if (mode == "spark" or torch.device(device).type != "cuda"
            or card_kernel(backend, device) != "fused"):
        return
    from repro_torch.kernels.contingency.ops import check_fused_shape

    try:
        check_fused_shape(max(min(int(mp_chunk), int(n_attrs)), 1), int(cap), int(m), device)
    except ValueError as e:
        raise ValueError(f"backend {backend!r} evaluates candidates on the card with the "
                         f"fused Θ kernel, which cannot take this table: {e}") from None


def _check_in(what: str, value, allowed: Sequence[str]) -> None:
    if value not in allowed:
        raise ValueError(f"unknown {what}: {value!r} (one of: {', '.join(allowed)})")


def check_mode(mode: str) -> None:
    _check_in("mode", mode, MODES)


def check_engine(engine: str) -> None:
    _check_in("engine", engine, ENGINES)


def check_backend(backend: str, allowed: Sequence[str] = _THETA_BACKENDS,
                  engine: str = "") -> None:
    """Raise unless ``backend`` is one of ``allowed``, the backends of the
    ``engine`` named (``"mesh "``, ``"stacked-engine "``; every one by
    default)."""
    _check_in(f"{engine}Θ backend", backend, allowed)


def check_selector(selector: Optional[str], what: str = "tile selector") -> None:
    """Raise unless ``selector`` is ``None`` (the default mode) or one of
    :data:`SELECTOR_MODES`; ``what`` names it in the message."""
    if selector is not None:
        _check_in(what, selector, SELECTOR_MODES)


def check_stacked(backend: str, ladder: bool = False) -> None:
    """Raise unless ``backend``, and ``ladder``, may ride the stacked engine.

    The stacked loop shares one rung across configs, which is bit-safe only
    under the slab backends' rung invariance (DESIGN.md §5.3).
    """
    check_backend(backend, ENSEMBLE_BACKENDS, "stacked-engine ")
    if ladder and not BACKENDS[backend].slab:
        raise ValueError(
            "the stacked engine's ladder requires a slab backend ("
            + ", ".join(b for b in ENSEMBLE_BACKENDS if BACKENDS[b].slab)
            + f"), not {backend!r}")


def ladder_rungs(n_bins: int, tile: int = LADDER_TILE, *,
                 selector: str = "heuristic",
                 g: Optional[int] = None,
                 m: Optional[int] = None) -> Tuple[int, ...]:
    """Static bin-bucket ladder for K-adaptive evaluation (DESIGN.md §5.3).

    Ascending pow2 multiples of ``tile`` strictly below ``n_bins``, closed by
    ``n_bins`` itself (the run's exact bound ``cap·v_max``).  A smaller
    rung's θ tiles are a prefix of a larger rung's, and every dropped
    trailing tile holds all-zero rows with θ' = 0, so results are bitwise
    equal at every rung ≥ K·V.

    ``selector="analytic"`` with the granule count ``g`` and the decision
    width ``m`` prunes the pow2 set by the modeled padding-vs-traffic
    trade-off (``kernels/contingency/model.prune_ladder_rungs``, the JAX
    package's function): the result is a subset closed over the exact top
    rung, so rungs change speed, never bits, and it is JAX's ladder exactly.
    Other selectors keep the full pow2 ladder.
    """
    rungs = []
    b = tile
    while b < n_bins:
        rungs.append(b)
        b *= 2
    rungs.append(n_bins)
    if selector == "analytic" and g is not None and m is not None:
        from repro_torch.kernels.contingency.model import prune_ladder_rungs

        return prune_ladder_rungs(rungs, int(g), int(m))
    return tuple(rungs)


def rung_for(k: int, v_max: int, rungs: Sequence[int]) -> int:
    """Host-side rung selection: smallest rung ≥ K·v_max."""
    need = max(k, 1) * v_max
    return next(r for r in rungs if r >= need)


def _sentineled(k: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """uint32 view of a key (int64), invalid slots set to the sentinel."""
    ku = k.to(torch.int64) & 0xFFFFFFFF
    return torch.where(valid, ku, torch.full_like(ku, SENTINEL))


def ids_by_sort(keys: Sequence[torch.Tensor], valid: torch.Tensor):
    """Exact dense ids for arbitrary sort keys (the reduceByKey grouping).

    ``keys[-1]`` is the primary sort key.  Returns ids in *original* order
    (int32) and the number of distinct keys K.  Invalid slots get id 0 and do
    not count.
    """
    n = valid.shape[0]
    sentineled = [_sentineled(k, valid) for k in keys]
    order = lexsort(sentineled)
    valid_s = valid[order]
    neq = torch.zeros((n - 1,), dtype=torch.bool, device=valid.device)
    for k in sentineled:
        ks = k[order]
        neq = neq | (ks[1:] != ks[:-1])
    b = torch.cat([torch.ones((1,), dtype=torch.bool, device=valid.device), neq]) & valid_s
    ids_sorted = torch.clamp(torch.cumsum(b.to(torch.int32), dim=0, dtype=torch.int32) - 1, min=0)
    ids = torch.zeros((n,), dtype=torch.int32, device=valid.device)
    ids[order] = torch.where(valid_s, ids_sorted, torch.zeros_like(ids_sorted))
    return ids, b.sum().to(torch.int32)


def subset_ids(gran: Granularity, cols, *, exact: bool, seed: int = 0):
    """Class ids of ``U/B`` for the column subset B."""
    cols = torch.as_tensor(cols, dtype=torch.int64, device=gran.device)
    x_sub = gran.x[:, cols]
    if exact:
        keys = [x_sub[:, j] for j in range(x_sub.shape[1])][::-1]
    else:
        keys = [row_fingerprints(x_sub, seed + 7919), row_fingerprints(x_sub, seed)]
    return ids_by_sort(keys, gran.valid)


# ---------------------------------------------------------------------------
# Contingency backends: packed ids [nc, G] → counts [nc, n_bins, m]
# ---------------------------------------------------------------------------


def _masked_w(w: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Weights as f32, zero on invalid slots (the kernels' ``w`` operand)."""
    return torch.where(valid, w, torch.zeros_like(w)).to(torch.float32)


def _segment_counts(seg: torch.Tensor, w_: torch.Tensor, n_bins: int, m: int) -> torch.Tensor:
    """Scatter-add ``w_`` into flat (bin, decision) segments, per candidate.

    ``seg [nc, G]``; segments outside ``[0, n_bins·m)`` land in one extra
    slot that is sliced off — JAX's ``segment_sum`` drops them.
    """
    nc = seg.shape[0]
    size = n_bins * m
    seg = torch.where((seg >= 0) & (seg < size), seg, torch.full_like(seg, size))
    out = torch.zeros((nc, size + 1), dtype=torch.float32, device=seg.device)
    out.scatter_add_(1, seg, w_.expand(nc, -1))
    return out[:, :size].reshape(nc, n_bins, m)


def _cont_segment(packed, d, w, valid, n_bins, m):
    w_ = _masked_w(w, valid)
    p = packed.to(torch.int64)
    seg = torch.where(valid, p * m + d.to(torch.int64), torch.full_like(p, n_bins * m))
    return _segment_counts(seg, w_, n_bins, m)


def _cont_onehot(packed, d, w, valid, n_bins, m, *, bin_chunk: int = 512):
    """One-hot contraction, chunked over bins — the TPU's MXU strategy in
    plain PyTorch (f32 matmul: ``allow_tf32`` is off by default for it)."""
    w_ = _masked_w(w, valid)
    wd = w_[:, None] * torch.nn.functional.one_hot(d.to(torch.int64), m).to(torch.float32)
    chunks = []
    for base in range(0, n_bins, bin_chunk):
        bins = torch.arange(base, base + bin_chunk, device=packed.device)
        onehot = (packed[:, :, None] == bins[None, None, :]).to(torch.float32)  # [nc, G, BK]
        chunks.append(torch.einsum("cgk,gm->ckm", onehot, wd))
    return torch.cat(chunks, dim=1)[:, :n_bins, :]


def _tile_kwargs(kernel: str, tiles: Optional[Sequence[int]]) -> dict:
    """A kernel wrapper's tiling keywords from a tuple in the order of
    ``model.TILE_FIELDS`` (``None``: the wrapper resolves them)."""
    if tiles is None:
        return {}
    from repro_torch.kernels.contingency.model import TILE_FIELDS

    if len(tiles) != len(TILE_FIELDS[kernel]):
        raise ValueError(f"{kernel} tiles are {TILE_FIELDS[kernel]}, got {tuple(tiles)}")
    return dict(zip(TILE_FIELDS[kernel], (int(t) for t in tiles)))


def _cont_kernel(packed, d, w, valid, n_bins, m, selector=None, tiles=None):
    from repro_torch.kernels.contingency.ops import contingency as _kernel

    return _kernel(packed, d, _masked_w(w, valid), n_bins=n_bins, n_dec=m, selector=selector,
                   **_tile_kwargs("contingency", tiles))


def candidate_contingency(
    packed: torch.Tensor,
    d: torch.Tensor,
    w: torch.Tensor,
    valid: torch.Tensor,
    *,
    n_bins: int,
    m: int,
    backend: str = "segment",
    selector: Optional[str] = None,
    tiles: Optional[Sequence[int]] = None,
) -> torch.Tensor:
    """counts[c, k, j] = Σ_g w_g · 1[packed[c,g] = k] · 1[d_g = j].

    The paper's REDUCE phase for a batch of candidates at once.  The
    ``pallas`` backend's CUDA launch takes ``tiles`` (``(threads, ctas)``)
    or resolves them with ``selector``.
    """
    if backend == "segment":
        return _cont_segment(packed, d, w, valid, n_bins, m)
    if backend == "onehot":
        return _cont_onehot(packed, d, w, valid, n_bins, m)
    if backend == "pallas":
        return _cont_kernel(packed, d, w, valid, n_bins, m, selector, tiles)
    raise ValueError(f"unknown contingency backend: {backend}")


# ---------------------------------------------------------------------------
# sweep backend: read-once candidate slab + tile-ordered θ (DESIGN.md §5.3)
# ---------------------------------------------------------------------------


def sweep_contingency(x_t, r_ids, d, w, valid, *, v_max: int, n_bins: int, m: int):
    """Fused-pack contingency: slab ``x_t [nc, G]`` + shared ``r_ids [G]``.

    Counts are scatter-adds of integer-valued f32 weights: exact and
    order-independent below 2²⁴, so the result is bit-identical to the
    ``segment`` backend's pack-then-reduce for every bin bound ≥ K·V.
    """
    w_ = _masked_w(w, valid)
    p = r_ids.to(torch.int64)[None, :] * v_max + x_t.to(torch.int64)
    seg = torch.where(valid, p * m + d.to(torch.int64), torch.full_like(p, n_bins * m))
    return _segment_counts(seg, w_, n_bins, m)


def theta_tiled_raw(delta: str, cont: torch.Tensor, *, tile: int = LADDER_TILE) -> torch.Tensor:
    """Sequential per-tile θ' accumulation over bin tiles — the CUDA Θ
    kernels' order, on a materialized contingency ``cont [nc, nb, m]``.

    ``cont`` is split into ``ceil(nb/tile)`` bin tiles (the trailing tile
    zero-padded); θ' is summed within each tile, then the per-tile partials
    are added in ascending tile order, one f32 add at a time.  This is the
    structure the bin ladder's bit-parity rests on (DESIGN.md §5.3): a
    smaller rung's tiles are a prefix of a larger rung's, and every dropped
    trailing tile holds only all-zero rows whose θ' is exactly 0.
    """
    nc, nb, m = cont.shape
    n_tiles = -(-nb // tile)
    if n_tiles * tile != nb:
        cont = torch.nn.functional.pad(cont, (0, 0, 0, n_tiles * tile - nb))
    partial = measures.RAW_ROWS[delta](cont.reshape(nc, n_tiles, tile, m)).sum(dim=-1)
    raw = torch.zeros((nc,), dtype=torch.float32, device=cont.device)
    for t in range(n_tiles):  # never cumsum: the CPU's accumulates in float64
        raw = raw + partial[:, t]
    return raw


def candidate_theta(
    delta: str,
    packed: Optional[torch.Tensor],
    d: torch.Tensor,
    w: torch.Tensor,
    valid: torch.Tensor,
    n,
    *,
    n_bins: int,
    m: int,
    backend: str = "segment",
    x_t: Optional[torch.Tensor] = None,
    r_ids: Optional[torch.Tensor] = None,
    v_max: Optional[int] = None,
    selector: Optional[str] = None,
    tiles: Optional[Sequence[int]] = None,
) -> torch.Tensor:
    """Θ(D|B∪{a})[c] for a batch of candidates — the full MAP+REDUCE+sum.

    ``segment``/``onehot``/``pallas`` materialize the contingency and reduce
    it with :func:`measures.evaluate`; ``fused``/``fused_xla`` fold the θ
    epilogue into the accumulation, and so does ``segment`` on a CUDA
    operand, which launches the fused kernel (``BACKENDS["segment"].card``):
    the same counts, Θ_PR the same bits, SCE/LCE/CCE summed in the kernel's
    tile order.  The sweep backends take the read-once
    slab operands ``x_t [nc, G]`` + ``r_ids [G]`` + ``v_max`` instead of
    ``packed`` (pass ``packed=None``); ``n_bins`` may be any ladder rung
    ≥ K·V with bitwise-identical results across rungs.  The CUDA backends
    (``pallas``, ``fused``, ``sweep``) launch with ``tiles``, in the order
    of ``model.TILE_FIELDS``, or resolve them with ``selector``; tiles never
    change a bit.
    """
    check_backend(backend)
    if backend in SWEEP_BACKENDS:
        if x_t is None or r_ids is None or v_max is None:
            raise ValueError(
                f"backend={backend!r} takes the slab operand form: pass "
                "x_t=, r_ids=, v_max= (and packed=None)")
        if backend == "sweep":
            from repro_torch.kernels.contingency.ops import sweep_theta

            return sweep_theta(x_t, r_ids, d, _masked_w(w, valid), n, delta=delta,
                               v_max=v_max, n_bins=n_bins, n_dec=m, selector=selector,
                               **_tile_kwargs("sweep", tiles))
        cont = sweep_contingency(x_t, r_ids, d, w, valid, v_max=v_max,
                                 n_bins=n_bins, m=m)
        return measures.theta_scale(delta, theta_tiled_raw(delta, cont), n)
    if card_kernel(backend, packed.device) == "fused":
        from repro_torch.kernels.contingency.ops import fused_theta

        return fused_theta(packed, d, _masked_w(w, valid), n, delta=delta,
                           n_bins=n_bins, n_dec=m, selector=selector,
                           **_tile_kwargs("fused", tiles))
    if backend == "fused_xla":
        cont = _cont_segment(packed, d, w, valid, n_bins, m)
        return measures.theta_scale(delta, theta_tiled_raw(delta, cont), n)
    cont = candidate_contingency(packed, d, w, valid, n_bins=n_bins, m=m,
                                 backend=backend, selector=selector, tiles=tiles)
    return measures.evaluate(delta, cont, n)


def contingency_from_ids(ids, d, w, valid, *, n_bins: int, m: int) -> torch.Tensor:
    """Single-subset contingency [n_bins, m] (used for Θ(D|R), Θ(D|C), core)."""
    return _cont_segment(ids[None, :], d, w, valid, n_bins, m)[0]


def theta_for_ids(delta: str, ids, gran: Granularity, *, n_bins: int):
    """Θ(D|B) given exact class ids of U/B."""
    cont = contingency_from_ids(ids, gran.d, gran.w, gran.valid, n_bins=n_bins, m=gran.n_dec)
    return measures.evaluate(delta, cont, gran.n_total)
