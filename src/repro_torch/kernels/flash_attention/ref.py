"""Plain PyTorch version of the flash-attention kernel: the ``attention_ref`` twin.

Dense softmax attention in f32 with GQA (query head h reads kv head
h // group), causal and sliding-window masks aligned to the sequence end
(query i sits at absolute position skv − sq + i), and a fully masked row
giving 0.  The wrapper in :mod:`.ops` runs it for tensors on the CPU;
``chip_smoke.py`` and ``tests/test_torch_cuda_lm.py`` hold the CUDA kernels
against it on the card.

:func:`attention_tc_ref` is a plain model of the tensor-core kernel's
numerics, for the tests: the same tile recurrence (64-key tiles, f32 online
softmax, the -1e30 sentinel), with p split into two bf16 parts, hi + lo,
before the product with v, and that product accumulated in f32.
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["attention_ref", "attention_tc_ref"]


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


NEG_INF = -1e30


def attention_tc_ref(
    q: torch.Tensor,  # [B, Hq, Sq, Dh]
    k: torch.Tensor,  # [B, Hkv, Skv, Dh]
    v: torch.Tensor,  # [B, Hkv, Skv, Dh]
    *,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    block_kv: int = 64,
) -> torch.Tensor:
    """The tensor-core kernel's arithmetic in plain PyTorch, tile by tile:
    s = q·kᵀ in f32 then the scale; m' = max(m, rowmax s), alpha = 0 while m
    is the sentinel, p = exp(s − m') on visible keys; l' = alpha·l + Σp (f32
    p); acc' = alpha·acc + hi·v + lo·v with hi = bf16(p), lo = bf16(p − hi)
    (f32 sums); out = acc / max(l, 1e-30)."""
    b, hq, sq, dh = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    group = hq // hkv
    if scale is None:
        scale = dh ** -0.5
    qf = q.float()
    kx = k.repeat_interleave(group, dim=1).float()
    vx = v.repeat_interleave(group, dim=1).float()
    qpos = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
    m = torch.full((b, hq, sq), NEG_INF, device=q.device)
    l = torch.zeros((b, hq, sq), device=q.device)
    acc = torch.zeros((b, hq, sq, dh), device=q.device)
    for k0 in range(0, skv, block_kv):
        k1 = min(k0 + block_kv, skv)
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kx[:, :, k0:k1]) * scale
        kpos = torch.arange(k0, k1, device=q.device)[None, :]
        mask = torch.ones((sq, k1 - k0), dtype=torch.bool, device=q.device)
        if causal:
            mask &= kpos <= qpos
        if window is not None:
            mask &= kpos > qpos - window
        s = torch.where(mask, s, torch.full((), NEG_INF, device=q.device))
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.where(m == NEG_INF, torch.zeros((), device=q.device), torch.exp(m - m_new))
        p = torch.where(mask, torch.exp(s - m_new[..., None]), torch.zeros((), device=q.device))
        l = alpha * l + p.sum(-1)
        hi = p.to(torch.bfloat16).float()
        lo = (p - hi).to(torch.bfloat16).float()
        vt = vx[:, :, k0:k1]
        pv = torch.einsum("bhqk,bhkd->bhqd", hi, vt) + torch.einsum("bhqk,bhkd->bhqd", lo, vt)
        acc = alpha[..., None] * acc + pv
        m = m_new
    return (acc / l.clamp_min(1e-30)[..., None]).to(q.dtype)
