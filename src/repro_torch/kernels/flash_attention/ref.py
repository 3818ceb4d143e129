"""Plain PyTorch version of the flash-attention kernel: the ``attention_ref`` twin.

Dense softmax attention in f32 with GQA (query head h reads kv head
h // group), causal and sliding-window masks aligned to the sequence end
(query i sits at absolute position skv − sq + i), and a fully masked row
giving 0.  The wrapper in :mod:`.ops` runs it for tensors on the CPU;
``chip_smoke.py`` and ``tests/test_torch_cuda_lm.py`` hold the CUDA kernel
against it on the card.
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["attention_ref"]


def attention_ref(
    q: torch.Tensor,  # [B, Hq, Sq, Dh]
    k: torch.Tensor,  # [B, Hkv, Skv, Dh]
    v: torch.Tensor,  # [B, Hkv, Skv, Dh]
    *,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Dense softmax attention; kv heads broadcast over query-head groups."""
    b, hq, sq, dh = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    group = hq // hkv
    if scale is None:
        scale = dh ** -0.5
    kx = k.repeat_interleave(group, dim=1).float()
    vx = v.repeat_interleave(group, dim=1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kx) * scale
    qpos = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
    kpos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = torch.where(mask, p, torch.zeros((), device=q.device))
    p = p / p.sum(-1, keepdim=True).clamp_min(1e-30)
    return torch.einsum("bhqk,bhkd->bhqd", p, vx).to(q.dtype)
