"""Public wrapper of the flash-attention kernel: dispatch on the input's device.

* CPU tensors run the plain PyTorch version (:func:`.ref.attention_ref`).
* CUDA tensors launch a hand-written CUDA kernel (built at first use by
  :mod:`repro_torch.kernels.build`) on PyTorch's current stream, or raise.
  The dtype and head width choose the kernel, explicitly:

  - bf16 at head widths :data:`TC_HEAD_DIMS` (64, 128, 256): the tensor-core
    kernel ``csrc/flash_attention_tc.cu`` (wgmma, TMA; p enters the product
    with v as two bf16 parts, hi + lo: one bf16 rounding of p, which the
    TPU kernel's f32 matmul at JAX's default precision makes on the MXU,
    puts outputs past the port's per-element check);
  - f32 at every width of :data:`HEAD_DIMS`, and bf16 at 16 and 32: the f32
    CUDA-core kernel ``csrc/flash_attention.cu``.  f32 never goes to the
    tensor cores: TF32 would break its 2e-5 agreement with the plain version.

  There is no fallback from one kernel to another or to the plain version.

Training goes through :func:`flash_attention_diff`, JAX's
``_diff_attention``: a ``torch.autograd.Function`` whose forward is
:func:`flash_attention` (the kernel on the card, the plain version on the
CPU) and whose backward recomputes :func:`.ref.attention_ref` on the saved
q, k, v and returns its vector-Jacobian product.  The kernel writes into
an ``empty_like`` buffer through ctypes, so its output carries no autograd
graph of its own: without the Function a training step on the card would
give q, k and v no gradient.  :func:`mha` is JAX's dispatch by name.

:data:`LAUNCHES` counts kernel launches (one per launch, nowhere else), so a
run can show that it went through the kernels: ``flash_attention`` counts
every launch, ``flash_attention_tc`` those of the tensor-core kernel.
On ``meta`` operands (the dry-run's modelled card) the wrapper is a
shape-only twin: an output like q, the call counted in :data:`MODELLED`.
A launch and a twin both hand :func:`kernel_cost` to
:func:`~repro_torch.kernels.launching.note_kernel`.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .. import build
from ..launching import modelled, note_kernel, on_cpu, stream
from .ref import attention_ref

__all__ = ["HEAD_DIMS", "LAUNCHES", "MODELLED", "TC_HEAD_DIMS", "flash_attention",
           "flash_attention_diff", "kernel_cost", "launch_counts", "mha", "modelled_counts",
           "reset_launch_counts", "reset_modelled_counts", "takes_tensor_cores"]

LAUNCHES: Dict[str, int] = {"flash_attention": 0, "flash_attention_tc": 0}
MODELLED: Dict[str, int] = {"flash_attention": 0, "flash_attention_tc": 0}   # twin calls
HEAD_DIMS = (16, 32, 64, 128, 256)  # the f32 kernel's compiled head widths
TC_HEAD_DIMS = (64, 128, 256)       # the tensor-core kernel's (bf16 only)
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = {
    "flash_attention": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _I, _I, _P],
    "flash_attention_tc": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _I, _P],
}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)


def reset_modelled_counts() -> None:
    for name in MODELLED:
        MODELLED[name] = 0


def modelled_counts() -> Dict[str, int]:
    return dict(MODELLED)


def kernel_cost(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
                window: Optional[int]) -> Tuple[float, float]:
    """(operations, bytes) of one forward: 4·Dh a visible (query, key) pair
    and query head (q·k and p·v; the causal and window masks aligned to the
    sequence end, as the kernel skips masked blocks), q, k, v read once and
    the output written once."""
    b, hq, sq, dh = q.shape
    skv = k.shape[2]
    pos = np.arange(sq, dtype=np.int64) + (skv - sq)
    hi = np.minimum(pos, skv - 1) if causal else np.full(sq, skv - 1, np.int64)
    lo = np.maximum(pos - window + 1, 0) if window else np.zeros(sq, np.int64)
    pairs = float(np.clip(hi - lo + 1, 0, None).sum())
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    return 4.0 * b * hq * dh * pairs, float(nbytes)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: q, k, v must be [B, H, S, Dh]")
    b, hq, _, dh = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != dh:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} does not fit "
                         f"k {tuple(k.shape)} / v {tuple(v.shape)}")
    if k.shape[1] == 0 or hq % k.shape[1]:
        raise ValueError(f"flash_attention: {hq} query heads over {k.shape[1]} kv heads")
    if dh not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {dh} not in {HEAD_DIMS}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash_attention: q must be float32 or bfloat16, got {q.dtype}")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype:
            raise TypeError(f"flash_attention: {name} must be {q.dtype} like q, got {t.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be contiguous")


def takes_tensor_cores(dtype: torch.dtype, head_dim: int) -> bool:
    """Whether a CUDA launch of this dtype and head width runs the
    tensor-core kernel (else the f32 CUDA-core kernel)."""
    return dtype == torch.bfloat16 and head_dim in TC_HEAD_DIMS


def _launcher(name: str):
    lib = build.load(name)
    fn = getattr(lib, f"{name}_launch")
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    return lib, fn


def flash_attention(
    q: torch.Tensor,  # [B, Hq, Sq, Dh]
    k: torch.Tensor,  # [B, Hkv, Skv, Dh]
    v: torch.Tensor,  # [B, Hkv, Skv, Dh]
    *,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    bq: int = 128,
    bkv: int = 128,
    interpret: bool = True,
) -> torch.Tensor:
    """Forward attention with GQA, causal / sliding-window masks aligned to
    the sequence end, f32 online softmax; output in q's dtype.
    ``bq``, ``bkv`` (the TPU kernel's query and key blocks) are accepted and
    ignored: the CUDA kernels fix their own tiles.
    ``interpret`` (Pallas's interpreter) is accepted and ignored.
    """
    if window is not None and window <= 0:
        raise ValueError(f"flash_attention: window must be positive, got {window}")
    if modelled(q=q, k=k, v=v):          # the dry-run's twin: shapes and costs only
        _check(q, k, v)
        MODELLED["flash_attention"] += 1
        if takes_tensor_cores(q.dtype, q.shape[3]):
            MODELLED["flash_attention_tc"] += 1
        note_kernel("flash_attention", lambda: kernel_cost(q, k, v, causal=causal, window=window))
        return torch.empty_like(q)
    if on_cpu("flash_attention", q=q, k=k, v=v):
        return attention_ref(q, k, v, causal=causal, window=window, scale=scale)
    _check(q, k, v)
    b, hq, sq, dh = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if scale is None:
        scale = dh ** -0.5
    out = torch.empty_like(q)
    tc = takes_tensor_cores(q.dtype, dh)
    if tc:
        for name, t in (("q", q), ("k", k), ("v", v)):
            if t.data_ptr() % 16:
                raise ValueError(f"flash_attention: {name} must start 16-byte aligned "
                                 "(a TMA tensor map's base)")
    head = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, hq, hkv, sq, skv, dh)
    tail = (float(scale), int(bool(causal)), int(window or 0), stream(q.device))
    with torch.cuda.device(q.device):
        if tc:
            lib, fn = _launcher("flash_attention_tc")
            err = fn(*head, *tail)
        else:
            lib, fn = _launcher("flash_attention")
            err = fn(*head, int(q.dtype == torch.bfloat16), *tail)
        build.check(lib, err, "flash_attention kernel launch")
    LAUNCHES["flash_attention"] += 1
    if tc:
        LAUNCHES["flash_attention_tc"] += 1
    note_kernel("flash_attention", lambda: kernel_cost(q, k, v, causal=causal, window=window))
    return out


BACKWARD_RANGE = "flash_attention_diff.backward"   # its profiler range (``profile_train``)


class _FlashAttentionDiff(torch.autograd.Function):
    """Kernel forward, reference-VJP backward (JAX ``_diff_attention``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        # the tensor-core kernel takes contiguous, 16-byte aligned operands
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        ctx.save_for_backward(q, k, v)
        ctx.opts = dict(causal=causal, window=window, scale=scale)
        return flash_attention(q, k, v, **ctx.opts)

    @staticmethod
    def backward(ctx, g):
        saved = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.profiler.record_function(BACKWARD_RANGE), torch.enable_grad():
            o = attention_ref(*saved, **ctx.opts)
            dq, dk, dv = torch.autograd.grad(o, saved, g)
        return dq, dk, dv, None, None, None


def flash_attention_diff(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True, window: Optional[int] = None,
                         scale: Optional[float] = None, bq: int = 128, bkv: int = 128,
                         interpret: bool = True) -> torch.Tensor:
    """Differentiable :func:`flash_attention`: the kernel's forward (the plain
    version on CPU tensors), the backward of :func:`.ref.attention_ref`.
    ``bq``, ``bkv`` (the TPU kernel's query and key blocks) are accepted and
    ignored: the CUDA kernels fix their own tiles.
    ``interpret`` (Pallas's interpreter) is accepted and ignored.
    """
    return _FlashAttentionDiff.apply(q, k, v, causal, window, scale)


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
        window: Optional[int] = None, scale: Optional[float] = None,
        impl: str = "pallas", interpret: bool = True) -> torch.Tensor:
    """Multi-head attention [B, H, S, Dh] with GQA kv broadcast, by JAX's
    implementation names: ``"pallas"`` the kernel (differentiable, through
    :func:`flash_attention_diff`), ``"xla"`` the plain version.
    ``interpret`` (Pallas's interpreter) is accepted and ignored.
    """
    if impl == "pallas":
        return flash_attention_diff(q, k, v, causal=causal, window=window, scale=scale)
    if impl == "xla":
        return attention_ref(q, k, v, causal=causal, window=window, scale=scale)
    raise ValueError(f"unknown attention impl: {impl}")
