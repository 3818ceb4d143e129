"""GQA self-attention: train / prefill (the flash kernel) and decode (KV cache).

The port's ``repro.models.attention``, four of its paths:

* ``full``   — self-attention over the whole sequence (train and prefill).
  By default through the flash-attention kernel
  (:mod:`repro_torch.kernels.flash_attention`) under its differentiable
  wrapper ``flash_attention_diff`` (kernel forward, plain backward) at
  every query length: the CUDA kernel has no row minimum.  The JAX package
  takes its Pallas kernel there from 8 query rows (a TPU tile limit) and its
  XLA stream below; both compute the same attention.  The config's
  training options select, as in JAX: ``attn_naive`` the direct S² einsum
  (:func:`_naive_attention`), ``flash_bwd`` the chunked stream with its
  hand-written streaming backward (:func:`flash_xla_attention`), both plain
  PyTorch, as JAX runs them without a Pallas kernel.
* ``decode`` — T new tokens against the padded KV cache, written in place
  at each sequence's length.
* ``cross``  — the enc-dec decoder's attention over the whole encoder
  memory (:func:`cross_attention`, a plain f32 einsum as in JAX, over K/V
  from :func:`project_cross_kv`, which carries no RoPE).

Not ported yet: the mesh paths and sharding constraints.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import flash_attention_diff

from .config import torch_dtype
from .layers import ParamDef, apply_rope, rms_norm

NEG_INF = -1e30


def attn_defs(cfg) -> Dict[str, ParamDef]:
    d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    dt = cfg.param_dtype
    defs = {
        "wq": ParamDef((d, hq * hd), "fan_in", dt),
        "wk": ParamDef((d, hkv * hd), "fan_in", dt),
        "wv": ParamDef((d, hkv * hd), "fan_in", dt),
        "wo": ParamDef((hq * hd, d), "fan_in", dt),
    }
    if cfg.qk_norm:
        defs["q_norm"] = ParamDef((hd,), "ones", dt)
        defs["k_norm"] = ParamDef((hd,), "ones", dt)
    return defs


def _project_qkv(params, x, positions, cfg, *, rope: bool = True):
    b, s, _ = x.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    cdt = torch_dtype(cfg.compute_dtype)
    q = (x @ params["wq"].to(cdt)).reshape(b, s, hq, hd).transpose(1, 2)
    k = (x @ params["wk"].to(cdt)).reshape(b, s, hkv, hd).transpose(1, 2)
    v = (x @ params["wv"].to(cdt)).reshape(b, s, hkv, hd).transpose(1, 2)
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"], cfg.norm_eps)
        k = rms_norm(k, params["k_norm"], cfg.norm_eps)
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q.contiguous(), k.contiguous(), v.contiguous()


# ---------------------------------------------------------------------------
# the chunked stream with a hand-written streaming backward (``flash_bwd``)
#
# Autograd of a chunked forward saves every kv-step's carry for the
# backward: O(S²·dh/kc) a layer.  This Function saves only (q, k, v, o,
# lse) and re-streams the kv blocks in the backward: O(S·chunk) memory.
# ---------------------------------------------------------------------------


def _pad_qkv(q, k, v, qc: int, kc: int):
    sq, skv = q.shape[2], k.shape[2]
    sq_pad = -(-sq // qc) * qc
    skv_pad = -(-skv // kc) * kc
    q = F.pad(q, (0, 0, 0, sq_pad - sq))
    k = F.pad(k, (0, 0, 0, skv_pad - skv))
    v = F.pad(v, (0, 0, 0, skv_pad - skv))
    return q, k, v, sq_pad, skv_pad


def _block_mask(qpos, kpos, skv: int, causal: bool, window: Optional[int]):
    mask = (kpos < skv)[None, :]
    if causal:
        mask = mask & (kpos[None, :] <= qpos[:, None])
    if window is not None:
        mask = mask & (kpos[None, :] > qpos[:, None] - window)
    return mask


def _flash_fwd_lse(q, k, v, causal, window, scale, qc, kc):
    """Chunked online-softmax forward that also returns lse = m + log(l)
    per query (for the backward): f32 sums, output in q's dtype."""
    b, hq, sq, dh = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    group = hq // hkv
    dev = q.device
    qp, kp, vp, sq_pad, skv_pad = _pad_qkv(q, k, v, qc, kc)
    qx = qp.reshape(b, hkv, group, sq_pad, dh)
    kx, vx = kp.float(), vp.float()
    neg = torch.full((), NEG_INF, device=dev)
    zero = torch.zeros((), device=dev)
    outs, lses = [], []
    for iq in range(sq_pad // qc):
        q_i = qx[:, :, :, iq * qc:(iq + 1) * qc].float()
        qpos = iq * qc + torch.arange(qc, device=dev) + (skv - sq)
        m = torch.full((b, hkv, group, qc), NEG_INF, device=dev)
        l = torch.zeros((b, hkv, group, qc), device=dev)
        acc = torch.zeros((b, hkv, group, qc, dh), device=dev)
        for ik in range(skv_pad // kc):
            k_j, v_j = kx[:, :, ik * kc:(ik + 1) * kc], vx[:, :, ik * kc:(ik + 1) * kc]
            s_ij = torch.einsum("bhgqd,bhkd->bhgqk", q_i, k_j) * scale
            mask = _block_mask(qpos, ik * kc + torch.arange(kc, device=dev), skv, causal, window)
            s_ij = torch.where(mask, s_ij, neg)
            m_new = torch.maximum(m, s_ij.amax(-1))
            alpha = torch.where(m == NEG_INF, zero, torch.exp(m - m_new))
            p = torch.where(mask, torch.exp(s_ij - m_new[..., None]), zero)
            l = alpha * l + p.sum(-1)
            acc = alpha[..., None] * acc + torch.einsum("bhgqk,bhkd->bhgqd", p, v_j)
            m = m_new
        outs.append((acc / l.clamp_min(1e-30)[..., None]).to(q.dtype))
        lses.append(m + torch.log(l.clamp_min(1e-30)))
    o = torch.cat(outs, dim=3).reshape(b, hq, sq_pad, dh)[:, :, :sq]
    lse = torch.cat(lses, dim=3).reshape(b, hq, sq_pad)[:, :, :sq]
    return o, lse


def _flash_bwd_stream(q, k, v, o, lse, g, causal, window, scale, qc, kc):
    """Re-streaming backward: dq summed over kv blocks, dk/dv over q blocks."""
    b, hq, sq, dh = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    group = hq // hkv
    dev = q.device
    qp, kp, vp, sq_pad, skv_pad = _pad_qkv(q, k, v, qc, kc)
    pad = (0, 0, 0, sq_pad - sq)
    qx = qp.reshape(b, hkv, group, sq_pad, dh).float()
    gx = F.pad(g, pad).reshape(b, hkv, group, sq_pad, dh).float()
    ox = F.pad(o, pad).reshape(b, hkv, group, sq_pad, dh).float()
    # padded q rows carry lse = -inf: zeroed below before exp overflows
    lx = F.pad(lse, (0, sq_pad - sq), value=NEG_INF).reshape(b, hkv, group, sq_pad)
    kx, vx = kp.float(), vp.float()
    delta = (gx * ox).sum(-1)                                      # [b, hkv, g, sq]
    zero = torch.zeros((), device=dev)
    dk = torch.zeros((b, hkv, skv_pad, dh), device=dev)
    dv = torch.zeros((b, hkv, skv_pad, dh), device=dev)
    dq_blocks = []
    for iq in range(sq_pad // qc):
        rows = slice(iq * qc, (iq + 1) * qc)
        q_i, g_i, l_i, d_i = qx[:, :, :, rows], gx[:, :, :, rows], lx[..., rows], delta[..., rows]
        qpos = iq * qc + torch.arange(qc, device=dev) + (skv - sq)
        dq_i = torch.zeros((b, hkv, group, qc, dh), device=dev)
        dk_blocks, dv_blocks = [], []
        for ik in range(skv_pad // kc):
            k_j, v_j = kx[:, :, ik * kc:(ik + 1) * kc], vx[:, :, ik * kc:(ik + 1) * kc]
            s_ij = torch.einsum("bhgqd,bhkd->bhgqk", q_i, k_j) * scale
            mask = _block_mask(qpos, ik * kc + torch.arange(kc, device=dev), skv, causal, window)
            mask = mask & (l_i[..., None] > NEG_INF / 2)
            p = torch.where(mask, torch.exp(torch.clamp_max(s_ij - l_i[..., None], 30.0)), zero)
            dv_blocks.append(torch.einsum("bhgqk,bhgqd->bhkd", p, g_i))
            dp = torch.einsum("bhgqd,bhkd->bhgqk", g_i, v_j)
            ds = p * (dp - d_i[..., None]) * scale
            dq_i = dq_i + torch.einsum("bhgqk,bhkd->bhgqd", ds, k_j)
            dk_blocks.append(torch.einsum("bhgqk,bhgqd->bhkd", ds, q_i))
        dk = dk + torch.cat(dk_blocks, dim=2)
        dv = dv + torch.cat(dv_blocks, dim=2)
        dq_blocks.append(dq_i)
    dq = torch.cat(dq_blocks, dim=3).reshape(b, hq, sq_pad, dh)[:, :, :sq]
    return dq.to(q.dtype), dk[:, :, :skv].to(k.dtype), dv[:, :, :skv].to(v.dtype)


class _FlashXlaDiff(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale, qc, kc):
        ctx.opts = (causal, window, scale, qc, kc)
        o, lse = _flash_fwd_lse(q, k, v, *ctx.opts)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, g):
        grads = _flash_bwd_stream(*ctx.saved_tensors, g.float(), *ctx.opts)
        return (*grads, None, None, None, None, None)


def flash_xla_attention(q, k, v, *, causal: bool = True, window: Optional[int] = None,
                        scale: Optional[float] = None, q_chunk: int = 1024,
                        kv_chunk: int = 1024) -> torch.Tensor:
    """O(S·chunk)-memory attention with the hand-written streaming backward."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    qc, kc = min(q_chunk, q.shape[2]), min(kv_chunk, k.shape[2])
    return _FlashXlaDiff.apply(q, k, v, causal, window, scale, qc, kc)


def _naive_attention(q, k, v, *, causal: bool, window: Optional[int], scale: float):
    """Direct S² einsum attention (JAX's dry-run probe path), f32 softmax."""
    b, hq, sq, dh = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    group = hq // hkv
    qx = q.reshape(b, hkv, group, sq, dh).float()
    s = torch.einsum("bhgqd,bhkd->bhgqk", qx, k.float()) * scale
    qpos = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
    kpos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    s = torch.where(mask, s, torch.full((), NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    return o.reshape(b, hq, sq, dh).to(q.dtype)


def self_attention_full(params, x, positions, cfg, *, causal: bool = True,
                        window: Optional[int] = None, return_kv: bool = False):
    """Train / prefill path.  Returns out [B, S, D], and (k, v) with ``return_kv``."""
    q, k, v = _project_qkv(params, x, positions, cfg)
    scale = cfg.hd ** -0.5
    if cfg.attn_naive:
        o = _naive_attention(q, k, v, causal=causal, window=window, scale=scale)
    elif cfg.flash_bwd:
        o = flash_xla_attention(q, k, v, causal=causal, window=window, scale=scale)
    else:
        o = flash_attention_diff(q, k, v, causal=causal, window=window, scale=scale)
    b, s = x.shape[0], x.shape[1]
    o = o.transpose(1, 2).reshape(b, s, cfg.n_heads * cfg.hd)
    out = o @ params["wo"].to(torch_dtype(cfg.compute_dtype))
    if return_kv:
        return out, (k, v)
    return out


def _masked_decode_attention(q, k_cache, v_cache, lengths, cfg, *, window=None):
    """q [B,Hq,T,Dh] vs cache [B,Hkv,S,Dh]; key j valid iff j < lengths[b]+t+1.

    Scores and the PV product accumulate in f32; the softmax is cast to q's
    dtype before the PV product, as the JAX package does (in bf16 that
    rounding is part of the result).
    """
    b, hq, t, dh = q.shape
    hkv, s = k_cache.shape[1], k_cache.shape[2]
    group = hq // hkv
    qx = q.reshape(b, hkv, group, t, dh).float()
    scores = torch.einsum("bhgqd,bhkd->bhgqk", qx, k_cache.float()) * (dh ** -0.5)
    kpos = torch.arange(s, device=q.device)[None, None, :]
    qabs = lengths[:, None, None] + torch.arange(t, device=q.device)[None, :, None]
    mask = kpos <= qabs                                            # [B, T, S]
    if window is not None:
        mask = mask & (kpos > qabs - window)
    scores = torch.where(mask[:, None, None], scores, torch.full((), NEG_INF, device=q.device))
    p = torch.softmax(scores, dim=-1)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p.to(q.dtype).float(), v_cache.float())
    return o.reshape(b, hq, t, dh).to(q.dtype)


def _write_cache(cache: torch.Tensor, new: torch.Tensor, write_pos: torch.Tensor) -> None:
    """cache [B,Hkv,S,Dh] ← new [B,Hkv,T,Dh] at write_pos [B,T], in place.

    The JAX package writes with a one-hot masked update, a form it needs for
    GSPMD; it is a plain overwrite, so indexing gives the same values.  A
    position past the cache matches no slot there and is dropped; here too.
    With one new token a row writes one slot, so the drop is a ``where``
    (no host sync); with more, a masked index.
    """
    b, t = write_pos.shape
    s = cache.shape[2]
    new = new.transpose(1, 2).to(cache.dtype)                      # [B, T, Hkv, Dh]
    rows = torch.arange(b, device=cache.device)[:, None].expand(b, t)
    keep = write_pos < s
    if t == 1:
        pos = write_pos.clamp(max=s - 1)
        cache[rows, :, pos] = torch.where(keep[..., None, None], new, cache[rows, :, pos])
    else:
        cache[rows[keep], :, write_pos[keep]] = new[keep]


def self_attention_decode(params, x, cfg, cache_k, cache_v, lengths, *, window=None
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Decode T new tokens; the cache is written in place at each sequence's
    length (modulo the cache size for a rolling window; RoPE positions stay
    absolute).  Returns (out, cache_k, cache_v)."""
    b, t, _ = x.shape
    s_cache = cache_k.shape[2]
    positions = lengths[:, None] + torch.arange(t, device=x.device)[None, :]
    q, k_new, v_new = _project_qkv(params, x, positions, cfg)
    write_pos = positions % s_cache if window is not None else positions
    _write_cache(cache_k, k_new, write_pos)
    _write_cache(cache_v, v_new, write_pos)
    if window is not None:
        # rolling cache: every live slot is attendable
        eff_len = torch.clamp(lengths, max=s_cache)
        o = _masked_decode_attention(q, cache_k, cache_v, eff_len, cfg, window=None)
    else:
        o = _masked_decode_attention(q, cache_k, cache_v, lengths, cfg)
    o = o.transpose(1, 2).reshape(b, t, cfg.n_heads * cfg.hd)
    out = o @ params["wo"].to(torch_dtype(cfg.compute_dtype))
    return out, cache_k, cache_v


def cross_attention(params, x, memory_k, memory_v, cfg) -> torch.Tensor:
    """Decoder cross-attention of x [B, T, D] over the encoder memory's K/V
    [B, Hkv, Se, Dh], every memory position visible; f32 scores, softmax and
    PV product, the output cast back to x's dtype before ``wo``."""
    b, t, _ = x.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    cdt = torch_dtype(cfg.compute_dtype)
    q = (x @ params["wq"].to(cdt)).reshape(b, t, hq, hd).transpose(1, 2)
    qx = q.reshape(b, hkv, hq // hkv, t, hd).float()
    scores = torch.einsum("bhgqd,bhkd->bhgqk", qx, memory_k.float()) * (hd ** -0.5)
    p = torch.softmax(scores, dim=-1)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, memory_v.float())
    o = o.reshape(b, hq, t, hd).to(x.dtype).transpose(1, 2).reshape(b, t, hq * hd)
    return o @ params["wo"].to(cdt)


def project_cross_kv(params, memory, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross-attention K/V [B, Hkv, Se, Dh] of the encoder output (no RoPE)."""
    b, se, _ = memory.shape
    hkv, hd = cfg.n_kv_heads, cfg.hd
    cdt = torch_dtype(cfg.compute_dtype)
    k = (memory @ params["wk"].to(cdt)).reshape(b, se, hkv, hd).transpose(1, 2)
    v = (memory @ params["wv"].to(cdt)).reshape(b, se, hkv, hd).transpose(1, 2)
    return k, v
