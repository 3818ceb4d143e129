"""Public wrappers of the contingency kernels: dispatch on the input's device.

* A CPU tensor runs the kernel's plain PyTorch version (:mod:`.ref`).
* A CUDA tensor launches the hand-written CUDA kernel (``csrc/``, built at
  first use by :mod:`.build`) on PyTorch's current stream, or raises.  There
  is no fallback to the plain version.

Each wrapper counts its launches in :data:`LAUNCHES` (one per kernel
launch, nowhere else), so a run can show that it went through the kernels.
Callers see the logical ``[nc, n_bins, n_dec]`` (contingency) or the
normalized ``[nc]`` Θ (fused, sweep) — the JAX package's wrapper contracts.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from repro_torch.core.measures import theta_scale

from .. import build
from ..launching import on_cpu as _on_cpu, stream as _stream
from .ref import contingency_ref, fused_theta_raw_ref, sweep_theta_ref

__all__ = ["LAUNCHES", "contingency", "fused_theta", "fused_theta_raw", "sweep_theta",
           "reset_launch_counts", "launch_counts", "theta_scale"]

LAUNCHES: Dict[str, int] = {"contingency": 0, "fused_theta": 0, "sweep_theta": 0}

_DELTA_CODE = {"PR": 0, "SCE": 1, "LCE": 2, "CCE": 3}
_TILE = 256  # bins per CTA of the Θ kernels (plan.LADDER_TILE)
_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = {
    "contingency": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "fused_theta": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "sweep_theta": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
}
_WORKSPACE_ARGTYPES = {"fused_theta": [_I, _I, _I, _I], "sweep_theta": [_I, _I, _I, _I, _I]}


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
        raise ValueError(f"{name}: shapes {shape} do not fit the kernel (a 256-bin tile's "
                         f"histogram past shared memory, or too many granules)")
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


def _check_smem(name: str, n_dec: int, device: torch.device) -> None:
    need = _TILE * n_dec * 4  # one 256-bin tile's histogram
    props = torch.cuda.get_device_properties(device)
    limit = getattr(props, "shared_memory_per_block_optin", 232448)
    if need > limit:
        raise ValueError(
            f"{name}: a 256-bin tile of n_dec={n_dec} decisions needs {need} "
            f"bytes of shared memory; a block may take {limit}")


def contingency(
    packed: torch.Tensor,  # [nc, G] int32
    d: torch.Tensor,       # [G] int32
    w: torch.Tensor,       # [G] float32 (already masked: 0 on padding slots)
    *,
    n_bins: int,
    n_dec: int,
) -> torch.Tensor:
    """counts[c, k, j] = Σ_g w_g · 1[packed[c,g]=k] · 1[d_g=j]."""
    if _on_cpu("contingency", packed=packed, d=d, w=w):
        return contingency_ref(packed, d, w, n_bins=n_bins, n_dec=n_dec)
    packed, d, w = packed.contiguous(), d.contiguous(), w.contiguous()
    _check("contingency", {"packed": torch.int32, "d": torch.int32, "w": torch.float32},
           packed=packed, d=d, w=w)
    nc, g = packed.shape
    if d.shape != (g,) or w.shape != (g,):
        raise ValueError(f"contingency: d/w must be [{g}], got {tuple(d.shape)}, {tuple(w.shape)}")
    out = torch.zeros((nc, n_bins, n_dec), dtype=torch.float32, device=packed.device)
    with torch.cuda.device(packed.device):
        lib, fn = _launcher("contingency")
        err = fn(packed.data_ptr(), d.data_ptr(), w.data_ptr(), out.data_ptr(),
                 nc, g, n_bins, n_dec, _stream(packed.device))
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
) -> torch.Tensor:
    """The unnormalized Θ'[c] of :func:`fused_theta`: the kernel's own output.

    Raw partials over disjoint granule sets (the data shards of the mesh's
    ``fused`` schedule) are summed first and scaled once with
    :func:`theta_scale`, so Θ_PR stays an integer-exact count sum and one
    division across shard counts.  The plain version is
    :func:`.ref.fused_theta_raw_ref`.
    """
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
    _check_smem("fused_theta", n_dec + 1, dev)  # a histogram row and a row value a bin
    raw = torch.empty((nc,), dtype=torch.float32, device=dev)
    if nc == 0:
        return raw
    with torch.cuda.device(dev):
        lib, fn = _launcher("fused_theta")
        workspace = _workspace(lib, "fused_theta", nc, g, n_bins, n_dec)
        err = fn(packed.data_ptr(), d.data_ptr(), w.data_ptr(), workspace.data_ptr(),
                 raw.data_ptr(), nc, g, n_bins, n_dec, code, _stream(dev))
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
                                              n_dec=n_dec), n)


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
    allocates.
    """
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
    with torch.cuda.device(dev):
        lib, fn = _launcher("sweep_theta")
        workspace = _workspace(lib, "sweep_theta", nc, g, v_max, n_bins, n_dec)
        err = fn(x_t.data_ptr(), r_ids.data_ptr(), d.data_ptr(), w.data_ptr(),
                 workspace.data_ptr(), raw.data_ptr(), nc, g, v_max, n_bins, n_dec, code,
                 _stream(dev))
        build.check(lib, err, "sweep_theta kernel launch")
    LAUNCHES["sweep_theta"] += 1
    return theta_scale(delta, raw, n)
