"""Public wrapper of the flash-attention kernel: dispatch on the input's device.

* CPU tensors run the plain PyTorch version (:func:`.ref.attention_ref`).
* CUDA tensors launch the hand-written CUDA kernel
  (``csrc/flash_attention.cu``, built at first use by
  :mod:`repro_torch.kernels.build`) on PyTorch's current stream, or raise.
  There is no fallback to the plain version.

:data:`LAUNCHES` counts kernel launches (one per launch, nowhere else), so a
run can show that it went through the kernel.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from .. import build
from ..launching import on_cpu, stream
from .ref import attention_ref

__all__ = ["HEAD_DIMS", "LAUNCHES", "flash_attention", "launch_counts",
           "reset_launch_counts"]

LAUNCHES: Dict[str, int] = {"flash_attention": 0}
HEAD_DIMS = (16, 32, 64, 128, 256)  # the kernel's compiled head widths
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, ctypes.c_float, _I, _I, _P]


def reset_launch_counts() -> None:
    LAUNCHES["flash_attention"] = 0


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)


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


def flash_attention(
    q: torch.Tensor,  # [B, Hq, Sq, Dh]
    k: torch.Tensor,  # [B, Hkv, Skv, Dh]
    v: torch.Tensor,  # [B, Hkv, Skv, Dh]
    *,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Forward attention with GQA, causal / sliding-window masks aligned to
    the sequence end, f32 online softmax; output in q's dtype."""
    if window is not None and window <= 0:
        raise ValueError(f"flash_attention: window must be positive, got {window}")
    if on_cpu("flash_attention", q=q, k=k, v=v):
        return attention_ref(q, k, v, causal=causal, window=window, scale=scale)
    _check(q, k, v)
    b, hq, sq, dh = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if scale is None:
        scale = dh ** -0.5
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        lib = build.load("flash_attention")
        fn = lib.flash_attention_launch
        if fn.argtypes is None:
            fn.argtypes = _ARGTYPES
            fn.restype = ctypes.c_int
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, hq, hkv,
                 sq, skv, dh, int(q.dtype == torch.bfloat16), float(scale),
                 int(bool(causal)), int(window or 0), stream(q.device))
        build.check(lib, err, "flash_attention kernel launch")
    LAUNCHES["flash_attention"] += 1
    return out
