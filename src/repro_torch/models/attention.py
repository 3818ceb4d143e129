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

Sharding, as in JAX: q/k/v/o weights are TP-sharded on the head axis,
activations are constrained per head when the head count divides the
``model`` axis, and the KV cache is head-sharded when the KV heads divide
it, else sequence-sharded (:func:`kv_cache_spec`).  Under a mesh JAX drops
to its XLA attention (a Pallas call does not partition under GSPMD); the
port keeps its kernels: every attention core runs in a :func:`shard_map`
island on each rank's local heads (all heads on every rank where the q or
KV heads do not divide the axis), the flash kernel on the full path.  The
decode island writes the local cache slice in place and, on a
sequence-sharded cache, combines the ranks' partial softmaxes with a
``pmax`` and two sums (``psum``) over ``model`` (flash-decode).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.api import (BATCH_AXES, FSDP_AXIS, TP_AXIS, P, active_mesh,
                                        axis_index, axis_size, constrain, fit_entry, pmax,
                                        psum, shard_map)
from repro_torch.kernels.flash_attention import flash_attention_diff

from .config import torch_dtype
from .layers import ParamDef, apply_rope, rms_norm

NEG_INF = -1e30


def attn_defs(cfg) -> Dict[str, ParamDef]:
    d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    dt = cfg.param_dtype
    defs = {
        "wq": ParamDef((d, hq * hd), (FSDP_AXIS, TP_AXIS), "fan_in", dt),
        "wk": ParamDef((d, hkv * hd), (FSDP_AXIS, TP_AXIS), "fan_in", dt),
        "wv": ParamDef((d, hkv * hd), (FSDP_AXIS, TP_AXIS), "fan_in", dt),
        "wo": ParamDef((hq * hd, d), (TP_AXIS, FSDP_AXIS), "fan_in", dt),
    }
    if cfg.qk_norm:
        defs["q_norm"] = ParamDef((hd,), (None,), "ones", dt)
        defs["k_norm"] = ParamDef((hd,), (None,), "ones", dt)
    return defs


def _maybe_head_axis(n_heads: int) -> Optional[str]:
    """TP axis name if the head count divides the mesh's model axis."""
    size = axis_size(TP_AXIS)
    if size > 1 and n_heads % size == 0:
        return TP_AXIS
    return None


def kv_cache_spec(cfg) -> P:
    """[B, Hkv, S, Dh] cache: head-sharded when divisible, else seq-sharded."""
    if _maybe_head_axis(cfg.n_kv_heads):
        return P(BATCH_AXES, TP_AXIS, None, None)
    return P(BATCH_AXES, None, TP_AXIS, None)


def split_heads(y: torch.Tensor, n_heads: int) -> torch.Tensor:
    """[B, S, H·Dh] → [B, H, S, Dh].  Under a mesh the projection is first
    kept sharded over ``model`` only where the heads divide it (DTensor
    cannot split a dim whose shards would cut heads)."""
    b, s, _ = y.shape
    y = constrain(y, BATCH_AXES, None, _maybe_head_axis(n_heads))
    return y.reshape(b, s, n_heads, -1).transpose(1, 2)


def _project_qkv(params, x, positions, cfg, *, rope: bool = True):
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    cdt = torch_dtype(cfg.compute_dtype)
    q = split_heads(x @ params["wq"].to(cdt), hq)
    k = split_heads(x @ params["wk"].to(cdt), hkv)
    v = split_heads(x @ params["wv"].to(cdt), hkv)
    q = constrain(q, BATCH_AXES, _maybe_head_axis(hq), None, None)
    kv_ax = _maybe_head_axis(hkv)
    k = constrain(k, BATCH_AXES, kv_ax, None, None)
    v = constrain(v, BATCH_AXES, kv_ax, None, None)
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


def _head_island_spec(b: int, hq: int, hkv: int) -> P:
    """[B, H, S, Dh] spec of an attention island: the batch over the data
    axes, the heads over ``model`` when both the q and the KV heads divide
    it (a rank then holds whole GQA groups), else every head on every rank."""
    heads = fit_entry(TP_AXIS, hq) if fit_entry(TP_AXIS, hkv) else None
    return P(fit_entry(BATCH_AXES, b), heads, None, None)


def self_attention_full(params, x, positions, cfg, *, causal: bool = True,
                        window: Optional[int] = None, return_kv: bool = False):
    """Train / prefill path.  Returns out [B, S, D], and (k, v) with ``return_kv``."""
    q, k, v = _project_qkv(params, x, positions, cfg)
    scale = cfg.hd ** -0.5
    if cfg.attn_naive:
        core = _naive_attention
    elif cfg.flash_bwd:
        core = flash_xla_attention
    else:
        core = flash_attention_diff

    def attend(q, k, v):
        return core(q.contiguous(), k.contiguous(), v.contiguous(), causal=causal,
                    window=window, scale=scale)

    mesh = active_mesh()
    if mesh is None:
        o = attend(q, k, v)
    else:   # the kernel on each rank's local heads
        spec = _head_island_spec(q.shape[0], cfg.n_heads, cfg.n_kv_heads)
        o = shard_map(attend, mesh=mesh, in_specs=(spec, spec, spec), out_specs=spec)(q, k, v)
    b, s = x.shape[0], x.shape[1]
    o = o.transpose(1, 2).reshape(b, s, cfg.n_heads * cfg.hd)
    out = o @ params["wo"].to(torch_dtype(cfg.compute_dtype))
    out = constrain(out, BATCH_AXES, None, None)
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


def _split_decode_attention(q, k_loc, v_loc, lengths, off: int, axis: str):
    """:func:`_masked_decode_attention` on one rank's slice of a
    sequence-sharded cache (its keys at ``off`` ...): local scores, the
    global max by ``pmax``, the softmax's denominator and the PV product
    summed over ``axis``.  The normalized softmax is cast to q's dtype before
    the PV product, as on one device."""
    b, hq, t, dh = q.shape
    hkv, s = k_loc.shape[1], k_loc.shape[2]
    qx = q.reshape(b, hkv, hq // hkv, t, dh).float()
    scores = torch.einsum("bhgqd,bhkd->bhgqk", qx, k_loc.float()) * (dh ** -0.5)
    kpos = off + torch.arange(s, device=q.device)[None, None, :]
    qabs = lengths[:, None, None] + torch.arange(t, device=q.device)[None, :, None]
    mask = (kpos <= qabs)[:, None, None]                           # [B, 1, 1, T, S]
    scores = torch.where(mask, scores, torch.full((), NEG_INF, device=q.device))
    m = pmax(scores.amax(-1, keepdim=True), axis)
    e = torch.exp(scores - m)
    p = e / psum(e.sum(-1, keepdim=True), axis)
    o = psum(torch.einsum("bhgqk,bhkd->bhgqd", p.to(q.dtype).float(), v_loc.float()), axis)
    return o.reshape(b, hq, t, dh).to(q.dtype)


def _write_cache(cache: torch.Tensor, new: torch.Tensor, write_pos: torch.Tensor) -> None:
    """cache [B,Hkv,S,Dh] ← new [B,Hkv,T,Dh] at write_pos [B,T], in place.

    The JAX package writes with a one-hot masked update, a form it needs for
    GSPMD; it is a plain overwrite, so indexing gives the same values.  A
    position outside the cache matches no slot there and is dropped; here
    too (a rank's slice of a sequence-sharded cache passes positions
    relative to its first slot).  With one new token a row writes one slot,
    so the drop is a ``where`` (no host sync); with more, a masked index.
    """
    b, t = write_pos.shape
    s = cache.shape[2]
    new = new.transpose(1, 2).to(cache.dtype)                      # [B, T, Hkv, Dh]
    rows = torch.arange(b, device=cache.device)[:, None].expand(b, t)
    keep = (write_pos >= 0) & (write_pos < s)
    if t == 1:
        pos = write_pos.clamp(0, s - 1)
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
    positions = lengths[:, None] + torch.arange(t, device=lengths.device)[None, :]
    write_pos = positions % s_cache if window is not None else positions
    # rolling cache: every live slot is attendable
    eff_len = torch.clamp(lengths, max=s_cache) if window is not None else lengths
    q, k_new, v_new = _project_qkv(params, x, constrain(positions, BATCH_AXES, None), cfg)

    def attend(q, cache_k, cache_v, k_new, v_new, write_pos, eff_len, seq_axis=None):
        off = 0
        if seq_axis is not None:       # this rank's slice of a sequence-sharded cache
            off = axis_index(seq_axis) * cache_k.shape[2]
        _write_cache(cache_k, k_new, write_pos - off)
        _write_cache(cache_v, v_new, write_pos - off)
        if seq_axis is None:
            return _masked_decode_attention(q, cache_k, cache_v, eff_len, cfg)
        return _split_decode_attention(q, cache_k, cache_v, eff_len, off, seq_axis)

    mesh = active_mesh()
    if mesh is None:
        o = attend(q, cache_k, cache_v, k_new, v_new, write_pos, eff_len)
    else:
        cspec = P(*(fit_entry(e, n) for e, n in zip(kv_cache_spec(cfg), cache_k.shape)))
        bt = P(cspec[0], None)
        if cspec[1] is not None:       # head-sharded cache: each rank its heads
            qspec = P(cspec[0], fit_entry(TP_AXIS, cfg.n_heads), None, None)
            seq_axis = None
        else:                          # sequence-sharded: every head on every rank
            qspec = P(cspec[0], None, None, None)
            seq_axis = cspec[2] if axis_size(TP_AXIS) > 1 else None
        kvspec = P(cspec[0], cspec[1], None, None)
        o = shard_map(lambda *a: attend(*a, seq_axis=seq_axis), mesh=mesh,
                      in_specs=(qspec, cspec, cspec, kvspec, kvspec, bt, P(cspec[0])),
                      out_specs=qspec)(q, cache_k, cache_v, k_new, v_new, write_pos, eff_len)
    o = o.transpose(1, 2).reshape(b, t, cfg.n_heads * cfg.hd)
    out = o @ params["wo"].to(torch_dtype(cfg.compute_dtype))
    return constrain(out, BATCH_AXES, None, None), cache_k, cache_v


def cross_attention(params, x, memory_k, memory_v, cfg) -> torch.Tensor:
    """Decoder cross-attention of x [B, T, D] over the encoder memory's K/V
    [B, Hkv, Se, Dh], every memory position visible; f32 scores, softmax and
    PV product, the output cast back to x's dtype before ``wo``."""
    b, t, _ = x.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    cdt = torch_dtype(cfg.compute_dtype)
    q = constrain(split_heads(x @ params["wq"].to(cdt), hq), BATCH_AXES, _maybe_head_axis(hq),
                  None, None)
    qx = q.reshape(b, hkv, hq // hkv, t, hd).float()
    scores = torch.einsum("bhgqd,bhkd->bhgqk", qx, memory_k.float()) * (hd ** -0.5)
    p = torch.softmax(scores, dim=-1)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, memory_v.float())
    o = o.reshape(b, hq, t, hd).to(x.dtype).transpose(1, 2).reshape(b, t, hq * hd)
    return constrain(o @ params["wo"].to(cdt), BATCH_AXES, None, None)


def project_cross_kv(params, memory, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross-attention K/V [B, Hkv, Se, Dh] of the encoder output (no RoPE)."""
    hkv = cfg.n_kv_heads
    cdt = torch_dtype(cfg.compute_dtype)
    k = split_heads(memory @ params["wk"].to(cdt), hkv)
    v = split_heads(memory @ params["wv"].to(cdt), hkv)
    ax = _maybe_head_axis(hkv)
    return constrain(k, BATCH_AXES, ax, None, None), constrain(v, BATCH_AXES, ax, None, None)
