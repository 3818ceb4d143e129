"""Public wrappers of the contingency kernels: dispatch on the input's device.

* A CPU tensor runs the kernel's plain PyTorch version (:mod:`.ref`).
* A CUDA tensor launches the hand-written CUDA kernel (``csrc/``, built at
  first use by :mod:`.build`) on PyTorch's current stream, or raises.  There
  is no fallback to the plain version.

Each wrapper counts its launches in :data:`LAUNCHES` (one per kernel
launch, nowhere else), so a run can show that it went through the kernels.
Callers see the logical ``[nc, n_bins, n_dec]`` (contingency) or the
normalized ``[nc]`` Θ (fused, sweep) — the JAX package's wrapper contracts.

Each wrapper takes its kernel's tiling as keywords (the fields of
:data:`.model.TILE_FIELDS`: ``threads``/``ctas``, ``chunk``/``threads``,
``bc``/``chunk``/``threads``) and ``selector=``; a field left ``None`` is
resolved by :func:`resolve_tiles` (``autotune.py``) for the launch's card,
in plain Python before the launch, so a CUDA graph that captures the launch
holds the tiles it was given.  The plain version needs no tiling and ignores it.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.core.measures import theta_scale

from .. import build
from ..launching import on_cpu as _on_cpu, stream as _stream
from .autotune import check_selector, resolve_tiles
from .model import TILE_FIELDS
from .ref import contingency_ref, fused_theta_raw_ref, sweep_theta_ref

__all__ = ["LAUNCHES", "check_fused_shape", "contingency", "fused_theta", "fused_theta_raw",
           "sweep_theta", "launch_tiles", "reset_launch_counts", "launch_counts", "resolve_tiles",
           "theta_scale"]

LAUNCHES: Dict[str, int] = {"contingency": 0, "fused_theta": 0, "sweep_theta": 0}

_DELTA_CODE = {"PR": 0, "SCE": 1, "LCE": 2, "CCE": 3}
_TILE = 256  # bins per CTA of the Θ kernels (plan.LADDER_TILE)
_INT_MAX = 2**31 - 1
_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = {
    "contingency": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "fused_theta": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "sweep_theta": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
}
_WORKSPACE_ARGTYPES = {"fused_theta": [_I] * 5, "sweep_theta": [_I] * 7}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)


def _launcher(name: str):
    lib = build.load(name)
    fn = getattr(lib, f"{name}_launch")
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    return lib, fn


def _workspace(lib, name: str, *shape: int) -> torch.Tensor:
    """The launch's scratch: ``{name}_workspace_bytes(*shape)`` bytes."""
    size = getattr(lib, f"{name}_workspace_bytes")
    if size.argtypes is None:
        size.argtypes = _WORKSPACE_ARGTYPES[name]
        size.restype = ctypes.c_size_t
    nbytes = size(*shape)
    if nbytes == 0:
        raise ValueError(f"{name}: shapes and tiling {shape} do not fit the kernel (a 256-bin "
                         f"tile's histogram past shared memory, too many granules, or a "
                         f"tiling the kernel has no instance of)")
    return torch.empty((nbytes,), dtype=torch.uint8, device=torch.cuda.current_device())


def _check(name: str, dtypes: Dict[str, torch.dtype], **tensors: torch.Tensor) -> None:
    for key, t in tensors.items():
        if t.dtype != dtypes[key]:
            raise TypeError(f"{name}: {key} must be {dtypes[key]}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")


def _check_delta(delta: str) -> int:
    if delta not in _DELTA_CODE:
        raise ValueError(f"unknown measure: {delta}")
    return _DELTA_CODE[delta]


def launch_tiles(kernel: str, given: Sequence[Optional[int]], *, selector: Optional[str],
                 device, nc: int, g: int, n_bins: int, m: int, v_max: int = 1,
                 delta: str = "SCE") -> Tuple[int, ...]:
    """The tiling a launch takes: the ``given`` fields (in the order of
    :data:`.model.TILE_FIELDS`), each ``None`` filled from
    :func:`resolve_tiles` for ``device``."""
    if len(given) != len(TILE_FIELDS[kernel]):
        raise ValueError(f"{kernel} tiles are {TILE_FIELDS[kernel]}, got {tuple(given)}")
    if all(v is not None for v in given):
        return tuple(int(v) for v in given)
    resolved = resolve_tiles(kernel, nc=nc, g=g, n_bins=n_bins, m=m, v_max=v_max,
                             delta=delta, selector=selector, device=device)
    return tuple(r if v is None else int(v) for v, r in zip(given, resolved))


def _check_smem(name: str, n_dec: int, device: torch.device) -> None:
    need = _TILE * n_dec * 4  # one 256-bin tile's histogram
    props = torch.cuda.get_device_properties(device)
    limit = getattr(props, "shared_memory_per_block_optin", 232448)
    if need > limit:
        raise ValueError(
            f"{name}: a 256-bin tile of n_dec={n_dec} decisions needs {need} "
            f"bytes of shared memory; a block may take {limit}")


def check_fused_shape(nc: int, g: int, n_dec: int, device) -> None:
    """Raise where :func:`fused_theta` on ``device`` cannot take ``nc``
    candidates over ``g`` granule slots and ``n_dec`` decisions: ``nc·g``
    keys past an int32, or a 256-bin tile's histogram and row values past
    a block's shared memory."""
    if nc * g > _INT_MAX:
        raise ValueError(f"fused_theta: {nc} candidates x {g} granules are {nc * g} keys; "
                         f"the kernel takes at most {_INT_MAX}")
    _check_smem("fused_theta", n_dec + 1, torch.device(device))


def contingency(
    packed: torch.Tensor,  # [nc, G] int32
    d: torch.Tensor,       # [G] int32
    w: torch.Tensor,       # [G] float32 (already masked: 0 on padding slots)
    *,
    n_bins: int,
    n_dec: int,
    threads: Optional[int] = None,
    ctas: Optional[int] = None,
    selector: Optional[str] = None,
) -> torch.Tensor:
    """counts[c, k, j] = Σ_g w_g · 1[packed[c,g]=k] · 1[d_g=j].

    Tiling: ``threads`` a CTA and at most ``ctas`` CTAs an SM.
    """
    check_selector(selector)
    if _on_cpu("contingency", packed=packed, d=d, w=w):
        return contingency_ref(packed, d, w, n_bins=n_bins, n_dec=n_dec)
    packed, d, w = packed.contiguous(), d.contiguous(), w.contiguous()
    _check("contingency", {"packed": torch.int32, "d": torch.int32, "w": torch.float32},
           packed=packed, d=d, w=w)
    nc, g = packed.shape
    if d.shape != (g,) or w.shape != (g,):
        raise ValueError(f"contingency: d/w must be [{g}], got {tuple(d.shape)}, {tuple(w.shape)}")
    threads, ctas = launch_tiles("contingency", (threads, ctas), selector=selector,
                                 device=packed.device, nc=nc, g=g, n_bins=n_bins, m=n_dec)
    out = torch.zeros((nc, n_bins, n_dec), dtype=torch.float32, device=packed.device)
    with torch.cuda.device(packed.device):
        lib, fn = _launcher("contingency")
        err = fn(packed.data_ptr(), d.data_ptr(), w.data_ptr(), out.data_ptr(),
                 nc, g, n_bins, n_dec, threads, ctas, _stream(packed.device))
        build.check(lib, err, "contingency kernel launch")
    LAUNCHES["contingency"] += 1
    return out


def fused_theta_raw(
    packed: torch.Tensor,  # [nc, G] int32
    d: torch.Tensor,       # [G] int32
    w: torch.Tensor,       # [G] float32 (already masked: 0 on padding slots)
    *,
    delta: str,
    n_bins: int,
    n_dec: int,
    chunk: Optional[int] = None,
    threads: Optional[int] = None,
    selector: Optional[str] = None,
) -> torch.Tensor:
    """The unnormalized Θ'[c] of :func:`fused_theta`: the kernel's own output.

    Raw partials over disjoint granule sets (the data shards of the mesh's
    ``fused`` schedule) are summed first and scaled once with
    :func:`theta_scale`, so Θ_PR stays an integer-exact count sum and one
    division across shard counts.  The plain version is
    :func:`.ref.fused_theta_raw_ref`.  Tiling: long segments in chunks of at
    least ``chunk`` keys, ``threads`` a CTA of the count and scatter passes.
    """
    check_selector(selector)
    if _on_cpu("fused_theta", packed=packed, d=d, w=w):
        return fused_theta_raw_ref(packed, d, w, delta=delta, n_bins=n_bins, n_dec=n_dec)
    packed, d, w = packed.contiguous(), d.contiguous(), w.contiguous()
    _check("fused_theta", {"packed": torch.int32, "d": torch.int32, "w": torch.float32},
           packed=packed, d=d, w=w)
    nc, g = packed.shape
    if d.shape != (g,) or w.shape != (g,):
        raise ValueError(f"fused_theta: d/w must be [{g}], got {tuple(d.shape)}, {tuple(w.shape)}")
    code = _check_delta(delta)
    if n_bins < 1:
        raise ValueError(f"fused_theta: n_bins must be >= 1, got {n_bins}")
    dev = d.device
    check_fused_shape(nc, g, n_dec, dev)
    raw = torch.empty((nc,), dtype=torch.float32, device=dev)
    if nc == 0:
        return raw
    chunk, threads = launch_tiles("fused", (chunk, threads), selector=selector, device=dev,
                                  nc=nc, g=g, n_bins=n_bins, m=n_dec, delta=delta)
    with torch.cuda.device(dev):
        lib, fn = _launcher("fused_theta")
        workspace = _workspace(lib, "fused_theta", nc, g, n_bins, n_dec, chunk)
        err = fn(packed.data_ptr(), d.data_ptr(), w.data_ptr(), workspace.data_ptr(),
                 raw.data_ptr(), nc, g, n_bins, n_dec, code, chunk, threads, _stream(dev))
        build.check(lib, err, "fused_theta kernel launch")
    LAUNCHES["fused_theta"] += 1
    return raw


def fused_theta(
    packed: torch.Tensor,  # [nc, G] int32
    d: torch.Tensor,       # [G] int32
    w: torch.Tensor,       # [G] float32 (already masked: 0 on padding slots)
    n,                     # |U| — normalization only, never enters the kernel
    *,
    delta: str,
    n_bins: int,
    n_dec: int,
    chunk: Optional[int] = None,
    threads: Optional[int] = None,
    selector: Optional[str] = None,
) -> torch.Tensor:
    """Θ(D|B∪{a})[c] without materializing the [nc, K, m] contingency.

    Semantics: the tile-ordered θ' epilogue over ``contingency(...)``, then
    the measure's one scale (:func:`fused_theta_ref`).  ``packed`` may hold
    any int32 keys; those outside ``[0, n_bins)`` count nothing.  On the
    card each candidate's live keys are ordered by their 256-bin tile
    first, so that each tile reads only its own segment
    (``csrc/fused_theta.cu``; the plain version of that ordering is
    :func:`.ref.candidate_segments`), in one workspace tensor the wrapper
    allocates.  The kernel's raw output is :func:`fused_theta_raw`.
    """
    return theta_scale(delta, fused_theta_raw(packed, d, w, delta=delta, n_bins=n_bins,
                                              n_dec=n_dec, chunk=chunk, threads=threads,
                                              selector=selector), n)


def sweep_theta(
    x_t: torch.Tensor,     # [nc, G] int32 — pre-transposed candidate slab
    r_ids: torch.Tensor,   # [G] int32 — shared class ids of U/R (-1: padding)
    d: torch.Tensor,       # [G] int32
    w: torch.Tensor,       # [G] float32 (already masked: 0 on padding slots)
    n,                     # |U| — normalization only, never enters the kernel
    *,
    delta: str,
    v_max: int,
    n_bins: int,
    n_dec: int,
    bc: Optional[int] = None,
    chunk: Optional[int] = None,
    threads: Optional[int] = None,
    selector: Optional[str] = None,
) -> torch.Tensor:
    """Θ(D|R∪{a})[c] from the read-once slab operands (DESIGN.md §5.3).

    Semantics: ``fused_theta(r_ids[None]·V + x_t, ...)`` with the pack done
    in the kernel; ``n_bins`` may be any ladder rung ≥ K·V.  ``x_t`` must
    hold attribute values in ``[0, v_max)``: the card kernel reads only the
    keys of a tile's own classes, so a value past ``v_max`` would be counted
    by the plain version and dropped here (``plar_reduce`` checks the table
    once a run).  On the card the granules are
    ordered by the tile bucket of their class first, so that each 256-bin
    tile reads only its own segment (``csrc/sweep_theta.cu``; the plain
    version of that ordering is :func:`.ref.tile_segments`).  The ordering
    is scratch of the launch: it lives in one workspace tensor the wrapper
    allocates.  Tiling: ``bc`` candidates read an entry at once (1, 2, 4, 8),
    then the fused kernel's ``chunk`` and ``threads``.
    """
    check_selector(selector)
    if _on_cpu("sweep_theta", x_t=x_t, r_ids=r_ids, d=d, w=w):
        return sweep_theta_ref(x_t, r_ids, d, w, n, delta=delta, v_max=v_max,
                               n_bins=n_bins, n_dec=n_dec)
    x_t, r_ids, d, w = x_t.contiguous(), r_ids.contiguous(), d.contiguous(), w.contiguous()
    _check("sweep_theta", {"x_t": torch.int32, "r_ids": torch.int32, "d": torch.int32,
                           "w": torch.float32}, x_t=x_t, r_ids=r_ids, d=d, w=w)
    nc, g = x_t.shape
    if r_ids.shape != (g,) or d.shape != (g,) or w.shape != (g,):
        raise ValueError(f"sweep_theta: r_ids/d/w must be [{g}]")
    code = _check_delta(delta)
    if n_bins < 1 or v_max < 1:
        raise ValueError(f"sweep_theta: n_bins and v_max must be >= 1, got {n_bins}, {v_max}")
    dev = d.device
    _check_smem("sweep_theta", n_dec + 1, dev)  # a histogram row and a row value a bin
    raw = torch.empty((nc,), dtype=torch.float32, device=dev)
    if nc == 0:
        return theta_scale(delta, raw, n)
    bc, chunk, threads = launch_tiles("sweep", (bc, chunk, threads), selector=selector,
                                      device=dev, nc=nc, g=g, n_bins=n_bins, m=n_dec,
                                      v_max=v_max, delta=delta)
    with torch.cuda.device(dev):
        lib, fn = _launcher("sweep_theta")
        workspace = _workspace(lib, "sweep_theta", nc, g, v_max, n_bins, n_dec, bc, chunk)
        err = fn(x_t.data_ptr(), r_ids.data_ptr(), d.data_ptr(), w.data_ptr(),
                 workspace.data_ptr(), raw.data_ptr(), nc, g, v_max, n_bins, n_dec, code,
                 bc, chunk, threads, _stream(dev))
        build.check(lib, err, "sweep_theta kernel launch")
    LAUNCHES["sweep_theta"] += 1
    return theta_scale(delta, raw, n)
