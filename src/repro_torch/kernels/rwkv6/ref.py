"""Plain PyTorch version of the RWKV6 kernel: the ``rwkv6_ref`` twin.

Per head, with state ``S ∈ R^{D × D}``, data-dependent per-channel decay
``w_t ∈ (0, 1)^D`` and bonus ``u ∈ R^D``:

    o_t = r_tᵀ (S_{t-1} + (u ⊙ k_t) v_tᵀ)
    S_t = diag(w_t) S_{t-1} + k_t v_tᵀ

a token loop in f32.  The wrapper in :mod:`.ops` runs it for tensors on the
CPU; ``chip_smoke.py`` and ``tests/test_torch_cuda_lm.py`` hold the CUDA
kernels against it on the card.

:func:`rwkv6_chunked_ref` is the plain version of the card's prefill
kernel's algebra: chunks of L tokens, each a few products in linear space
built from running products of the decays (never a ratio of them).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = ["rwkv6_chunked_ref", "rwkv6_ref"]


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


def rwkv6_chunked_ref(
    r: torch.Tensor,  # [B, H, T, D]
    k: torch.Tensor,  # [B, H, T, D]
    v: torch.Tensor,  # [B, H, T, D]
    w: torch.Tensor,  # [B, H, T, D] decay in [0, 1]
    u: torch.Tensor,  # [H, D] bonus
    init_state: Optional[torch.Tensor] = None,  # [B, H, D, D]
    *,
    chunk: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The recurrence of :func:`rwkv6_ref` in chunks of ``chunk`` tokens.

    For a chunk of n tokens entering with state S₀, with A_t = Π_{s<t} w_s
    and B_s = Π_{s<q<n} w_q (running products from the chunk's ends):

        o_t = (r_t ⊙ A_t)·S₀ + Σ_{s<t} M[t, s]·v_s + (r_t·(u ⊙ k_t))·v_t
        M[t, s] = Σ_i r_t[i]·k_s[i]·Π_{s<q<t} w_q[i]
        S_n = diag(A_n)·S₀ + Σ_s (k_s ⊙ B_s)ᵀ·v_s

    M is built along its diagonals: P_1[t] = r_t, P_{δ+1}[t] = P_δ[t] ⊙
    w_{t−δ}, M[t, t−δ] = P_δ[t]·k_{t−δ}.  Every factor is a product of decays
    in [0, 1], so nothing overflows; a product that underflows is 0, where
    the ratio A_t / A_{s+1} would be 0/0 once A underflows (the model's
    decays reach below 1e-30).  Autograd runs through it (``rwkv6_diff``'s
    backward): no tensor that a product saved is written in place.
    """
    b, h, t, d = r.shape
    s = (torch.zeros((b, h, d, d), dtype=torch.float32, device=r.device)
         if init_state is None else init_state.float())
    rf, kf, vf, wf = r.float(), k.float(), v.float(), w.float()
    uf = u.float()[None, :, None, :]                          # [1, H, 1, D]
    outs = []
    for c0 in range(0, t, chunk):
        rc, kc, vc, wc = (x[:, :, c0:c0 + chunk] for x in (rf, kf, vf, wf))
        n = rc.shape[2]
        ones = torch.ones_like(wc[:, :, :1])
        a = torch.cat([ones, torch.cumprod(wc, dim=2)], dim=2)          # A_0 .. A_n
        bs = torch.cat([torch.cumprod(wc.flip(2), dim=2).flip(2)[:, :, 1:], ones], dim=2)
        m = torch.diag_embed((rc * uf * kc).sum(-1))                    # the bonus term
        p = rc                                           # P_δ[t], for t >= δ
        for delta in range(1, n):
            m[:, :, delta:, :n - delta] += torch.diag_embed(
                (p[:, :, delta:] * kc[:, :, :n - delta]).sum(-1))
            # a new tensor, not an in-place product: autograd keeps each P_δ
            p = torch.cat([p[:, :, :delta], p[:, :, delta:] * wc[:, :, :n - delta]], dim=2)
        outs.append((rc * a[:, :, :n]) @ s + m @ vc)
        s = a[:, :, n, :, None] * s + (kc * bs).transpose(-1, -2) @ vc
    o = torch.cat(outs, dim=2) if outs else torch.zeros_like(rf)
    return o.to(r.dtype), s
