"""GQA self-attention: prefill (the flash kernel) and decode (KV cache).

The port's ``repro.models.attention``, two of its paths:

* ``full``   — self-attention over the whole sequence (prefill), through
  the flash-attention kernel (:mod:`repro_torch.kernels.flash_attention`) at
  every query length: the CUDA kernel has no row minimum.  The JAX package
  takes its Pallas kernel there from 8 query rows (a TPU tile limit) and its
  XLA stream below; both compute the same attention.
* ``decode`` — T new tokens against the padded KV cache, written in place
  at each sequence's length.

Not ported yet: the mesh paths and sharding constraints, the training
backward (``flash_xla_attention`` / ``flash_bwd``), the probe-only naive
attention and the cross attention of the enc-dec family.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels.flash_attention import flash_attention

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


def self_attention_full(params, x, positions, cfg, *, causal: bool = True,
                        window: Optional[int] = None, return_kv: bool = False):
    """Prefill path.  Returns out [B, S, D], and (k, v) with ``return_kv``."""
    q, k, v = _project_qkv(params, x, positions, cfg)
    scale = cfg.hd ** -0.5
    o = flash_attention(q, k, v, causal=causal, window=window, scale=scale)
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
