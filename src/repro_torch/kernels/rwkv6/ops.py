"""Public wrapper of the RWKV6 kernels: dispatch on the input's device.

* CPU tensors run the plain PyTorch version (:func:`.ref.rwkv6_ref`).
* CUDA tensors launch a hand-written CUDA kernel (``csrc/rwkv6.cu``, built
  at first use by :mod:`repro_torch.kernels.build`) on PyTorch's current
  stream, or raise.  There is no fallback to the plain version.  Below
  :data:`CHUNK` tokens (a decode step) the row-split decode kernel runs,
  from :data:`CHUNK` tokens on (a prefill) the chunked kernel, whose plain
  version is :func:`.ref.rwkv6_chunked_ref`.

Training goes through :func:`rwkv6_diff`, JAX's ``_diff_rwkv6``: a
``torch.autograd.Function`` whose forward is :func:`rwkv6` and whose
backward is the vector-Jacobian product of the plain recurrence for all
six inputs.  The kernels write into ``empty_like`` buffers through ctypes,
so their outputs carry no autograd graph of their own.  JAX's backward
differentiates the token loop of ``rwkv6_ref``, which keeps one ``[B, H,
D, D]`` f32 state a token (≈1.3 GB a layer at B 2, H 40, T 1,024); the
port's differentiates :func:`.ref.rwkv6_chunked_ref` at :data:`CHUNK`
tokens a chunk, the same function, which keeps one state a chunk.

:data:`LAUNCHES` counts kernel launches (one per launch, nowhere else):
``rwkv6`` every launch, ``rwkv6_decode`` and ``rwkv6_chunked`` each path's,
so a run can show that it went through both.  On ``meta`` operands (the
dry-run's modelled card) the wrapper is a shape-only twin (o and the final
state, f32), counted in :data:`MODELLED`; a launch and a twin both hand
:func:`kernel_cost` to :func:`~repro_torch.kernels.launching.note_kernel`.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch

from .. import build
from ..launching import modelled, note_kernel, on_cpu, stream
from .ref import rwkv6_chunked_ref, rwkv6_ref

__all__ = ["CHUNK", "HEAD_DIMS", "LAUNCHES", "MODELLED", "chunk_split", "column_split",
           "kernel_cost", "launch_counts", "modelled_counts", "reset_launch_counts",
           "reset_modelled_counts", "rwkv6", "rwkv6_diff", "rwkv6_scan"]

LAUNCHES: Dict[str, int] = {"rwkv6": 0, "rwkv6_decode": 0, "rwkv6_chunked": 0}
MODELLED: Dict[str, int] = {"rwkv6": 0, "rwkv6_decode": 0, "rwkv6_chunked": 0}  # twin calls
HEAD_DIMS = (4, 8, 16, 32, 64)  # the kernels' compiled head widths
CHUNK = 16  # tokens a chunk, compiled into the chunked kernel (kChunk): 16 beat 32 (PERF.md)
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 8 + [_I] * 6 + [_P]


def reset_launch_counts() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)


def reset_modelled_counts() -> None:
    for key in MODELLED:
        MODELLED[key] = 0


def modelled_counts() -> Dict[str, int]:
    return dict(MODELLED)


def kernel_cost(b: int, h: int, t: int, d: int) -> Tuple[float, float]:
    """(operations, bytes) of one call over [B, H, T, D]: 7·D² a (b, h,
    token) (kᵀv, its u-scaled copy and sum, r against it, the decay and the
    state update), r, k, v, w, u and the initial state read once, the output
    and the final state written once, all f32."""
    flops = 7.0 * b * h * t * d * d
    nbytes = 4.0 * (5 * b * h * t * d + h * d + 2 * b * h * d * d)
    return flops, nbytes


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def column_split(bh: int, d: int, n_sm: int) -> int:
    """CTAs per (b, h) of the decode kernel: 1, 2 or 4, doubled while the
    grid has fewer CTAs than the card has SMs and each CTA keeps at least 16
    columns."""
    split = 1
    while split < 4 and bh * split < n_sm and d // (2 * split) >= 16:
        split *= 2
    return split


def chunk_split(bh: int, d: int, n_sm: int) -> int:
    """CTAs per (b, h) of the chunked kernel: 1, 2 or 4, doubled while the
    grid stays within one CTA an SM and each CTA keeps at least 16 columns.
    A chunk's serial steps bound each CTA, so an SM that held two CTAs
    would finish last (one rwkv6-3b request: 80 CTAs, not 160)."""
    split = 1
    while split < 4 and bh * 2 * split <= n_sm and d // (2 * split) >= 16:
        split *= 2
    return split


def rwkv6(
    r: torch.Tensor,  # [B, H, T, D] f32
    k: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,  # decay in (0, 1)
    u: torch.Tensor,  # [H, D] f32
    init_state: Optional[torch.Tensor] = None,  # [B, H, D, D] f32
    *,
    impl: str = "pallas",
    chunk: int = 128,
    interpret: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The RWKV6 recurrence over [B, H, T, D]; returns (o, final state).

    ``impl`` has JAX's meaning: ``"pallas"`` the kernel (the plain version
    on CPU tensors), ``"xla"`` the plain version :func:`.ref.rwkv6_ref`.
    On the card, T < :data:`CHUNK` takes the decode kernel and T >=
    :data:`CHUNK` the chunked kernel.
    ``chunk`` (the TPU kernel's time block) is accepted and ignored: the
    CUDA chunk length is :data:`CHUNK`, compiled in.
    ``interpret`` (Pallas's interpreter) is accepted and ignored.
    """
    if impl == "xla":
        return rwkv6_ref(r, k, v, w, u, init_state)
    if impl != "pallas":
        raise ValueError(f"unknown rwkv6 impl: {impl}")
    return _rwkv6_kernel(r, k, v, w, u, init_state)


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
               u: torch.Tensor, init_state: Optional[torch.Tensor] = None, *,
               chunk: int = 128, interpret: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """The raw kernel entry, with JAX's signature: the CUDA kernels of
    ``csrc/rwkv6.cu`` on CUDA tensors.  A raw kernel entry has no plain
    fallback, so CPU tensors raise (:func:`rwkv6` takes them).
    ``chunk`` (the TPU kernel's time block) is accepted and ignored: the
    CUDA chunk length is :data:`CHUNK`, compiled in.
    ``interpret`` (Pallas's interpreter) is accepted and ignored.
    """
    if r.device.type not in ("cuda", "meta"):
        raise ValueError("rwkv6_scan: the raw kernel entry needs CUDA tensors "
                         "(rwkv6 runs the plain version on the CPU)")
    return _rwkv6_kernel(r, k, v, w, u, init_state)


def _rwkv6_kernel(r, k, v, w, u, init_state):
    """The kernel on CUDA tensors, the plain version on CPU tensors."""
    tensors = dict(r=r, k=k, v=v, w=w, u=u)
    if init_state is not None:
        tensors["init_state"] = init_state
    if modelled(**tensors):              # the dry-run's twin: shapes and costs only
        b, h, t, d = r.shape
        path = "rwkv6_decode" if t < CHUNK else "rwkv6_chunked"
        MODELLED["rwkv6"] += 1
        MODELLED[path] += 1
        note_kernel("rwkv6", lambda: kernel_cost(b, h, t, d))
        return (torch.empty_like(r, dtype=torch.float32),
                torch.empty((b, h, d, d), dtype=torch.float32, device=r.device))
    if on_cpu("rwkv6", **tensors):
        return rwkv6_ref(r, k, v, w, u, init_state)
    if r.dim() != 4:
        raise ValueError("rwkv6: r, k, v, w must be [B, H, T, D]")
    b, h, t, d = r.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"rwkv6: head_dim {d} not in {HEAD_DIMS}")
    if init_state is None:
        init_state = torch.zeros((b, h, d, d), dtype=torch.float32, device=r.device)
    tensors["init_state"] = init_state
    shapes = {"r": (b, h, t, d), "k": (b, h, t, d), "v": (b, h, t, d),
              "w": (b, h, t, d), "u": (h, d), "init_state": (b, h, d, d)}
    for name, x in tensors.items():
        if tuple(x.shape) != shapes[name]:
            raise ValueError(f"rwkv6: {name} must be {list(shapes[name])}, got {list(x.shape)}")
        if x.dtype != torch.float32:
            raise TypeError(f"rwkv6: {name} must be torch.float32, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"rwkv6: {name} must be contiguous")
    o = torch.empty_like(r)
    s_fin = torch.empty_like(init_state)
    n_sm = _sm_count(r.device.index if r.device.index is not None
                     else torch.cuda.current_device())
    path = "rwkv6_decode" if t < CHUNK else "rwkv6_chunked"
    split = column_split if path == "rwkv6_decode" else chunk_split
    with torch.cuda.device(r.device):
        lib = build.load("rwkv6")
        fn = lib.rwkv6_launch
        if fn.argtypes is None:
            fn.argtypes = _ARGTYPES
            fn.restype = ctypes.c_int
        err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
                 init_state.data_ptr(), o.data_ptr(), s_fin.data_ptr(), b * h, h, t, d,
                 split(b * h, d, n_sm), int(path == "rwkv6_decode"),
                 stream(r.device))
        build.check(lib, err, f"{path} kernel launch")
    LAUNCHES["rwkv6"] += 1
    LAUNCHES[path] += 1
    note_kernel("rwkv6", lambda: kernel_cost(b, h, t, d))
    return o, s_fin


BACKWARD_RANGE = "rwkv6_diff.backward"   # its profiler range (``profile_train``)


class _Rwkv6Diff(torch.autograd.Function):
    """Kernel forward, plain-recurrence VJP backward (JAX ``_diff_rwkv6``)."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, s0):
        ctx.save_for_backward(r, k, v, w, u, s0)
        ctx.set_materialize_grads(False)   # an unused final state costs no backward
        return rwkv6(r, k, v, w, u, s0)

    @staticmethod
    def backward(ctx, g_o, g_s):
        saved = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.profiler.record_function(BACKWARD_RANGE), torch.enable_grad():
            o, s_fin = rwkv6_chunked_ref(*saved, chunk=CHUNK)
            outs, grads = zip(*[(t, g) for t, g in ((o, g_o), (s_fin, g_s)) if g is not None])
            return torch.autograd.grad(outs, saved, grads, allow_unused=True,
                                       materialize_grads=True)


def rwkv6_diff(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
               u: torch.Tensor, s0: torch.Tensor, *, chunk: int = 128,
               interpret: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Differentiable :func:`rwkv6` (o, final state): the kernels' forward
    (the plain version on CPU tensors), the plain recurrence's backward for
    r, k, v, w, u and s0.
    ``chunk`` (the TPU kernel's time block) is accepted and ignored: the
    CUDA chunk length is :data:`CHUNK`, compiled in.
    ``interpret`` (Pallas's interpreter) is accepted and ignored.
    """
    return _Rwkv6Diff.apply(r, k, v, w, u, s0)
