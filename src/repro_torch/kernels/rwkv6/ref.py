"""Plain PyTorch version of the RWKV6 kernel: the ``rwkv6_ref`` twin.

Per head, with state ``S ∈ R^{D × D}``, data-dependent per-channel decay
``w_t ∈ (0, 1)^D`` and bonus ``u ∈ R^D``:

    o_t = r_tᵀ (S_{t-1} + (u ⊙ k_t) v_tᵀ)
    S_t = diag(w_t) S_{t-1} + k_t v_tᵀ

a token loop in f32.  The wrapper in :mod:`.ops` runs it for tensors on the
CPU; ``chip_smoke.py`` and ``tests/test_torch_cuda_lm.py`` hold the CUDA
kernel against it on the card.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = ["rwkv6_ref"]


def rwkv6_ref(
    r: torch.Tensor,  # [B, H, T, D]
    k: torch.Tensor,  # [B, H, T, D]
    v: torch.Tensor,  # [B, H, T, D]
    w: torch.Tensor,  # [B, H, T, D] decay in (0, 1)
    u: torch.Tensor,  # [H, D] bonus
    init_state: Optional[torch.Tensor] = None,  # [B, H, D, D]
) -> Tuple[torch.Tensor, torch.Tensor]:
    b, h, t, d = r.shape
    s = (torch.zeros((b, h, d, d), dtype=torch.float32, device=r.device)
         if init_state is None else init_state.float())
    rf, kf, vf, wf = r.float(), k.float(), v.float(), w.float()
    uf = u.float()[None]                                      # [1, H, D]
    outs = []
    for i in range(t):
        r_t, k_t, v_t, w_t = rf[:, :, i], kf[:, :, i], vf[:, :, i], wf[:, :, i]
        bonus = (uf * k_t)[..., :, None] * v_t[..., None, :]  # [B, H, D, D]
        outs.append(torch.einsum("bhi,bhij->bhj", r_t, s + bonus))
        s = w_t[..., :, None] * s + k_t[..., :, None] * v_t[..., None, :]
    o = torch.stack(outs, dim=2) if outs else torch.zeros_like(rf)
    return o.to(r.dtype), s
