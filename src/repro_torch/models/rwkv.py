"""RWKV6 (Finch) block: time-mix with data-dependent decay + channel-mix.

The port's ``repro.models.rwkv``, with the JAX package's one simplification:
the token-shift interpolation weights are static learned vectors, while the
decay keeps its full LoRA data dependence,

    w_t = exp(-exp(w0 + tanh(x̃_t W_a) W_b))          (per channel, per token)

in f32 (``w0``, ``w_lora_*`` and ``bonus_u`` are f32 parameters in bf16
configs).  The recurrence runs through the RWKV6 kernel
(:mod:`repro_torch.kernels.rwkv6`) in every call, prefill and decode, on r,
k, v, w cast to f32; with grad enabled (training) under its differentiable
wrapper ``rwkv6_diff`` (kernel forward, plain backward), as JAX's time-mix
calls ``rwkv6_diff``.  The token-shift state is ``[B, D]`` (the last token).

Heads are TP-sharded: each head's [Dh, Dh] state is local to its rank, so
the only collectives of a block are the in/out projections'.  Under a mesh
the kernel runs in a :func:`shard_map` island on each rank's local heads
(every head where the count does not divide the ``model`` axis: 40 heads on
16 ranks), where JAX drops to its plain reference scan.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.distributed.api import (BATCH_AXES, FSDP_AXIS, TP_AXIS, P, active_mesh,
                                        constrain, fit_entry, grad_in_placements, shard_map)
from repro_torch.kernels.rwkv6 import rwkv6, rwkv6_diff

from .config import torch_dtype
from .attention import split_heads
from .layers import ParamDef

LN_X_EPS = 64e-5  # the per-head group norm's eps


def rwkv_defs(cfg) -> Dict[str, ParamDef]:
    d, f = cfg.d_model, cfg.d_ff
    h, hd = cfg.rwkv_heads, cfg.rwkv_head_dim
    r = cfg.rwkv_decay_lora
    dt = cfg.param_dtype
    return {
        # time-mix
        "mu_r": ParamDef((d,), (None,), "normal", dt),
        "mu_k": ParamDef((d,), (None,), "normal", dt),
        "mu_v": ParamDef((d,), (None,), "normal", dt),
        "mu_w": ParamDef((d,), (None,), "normal", dt),
        "mu_g": ParamDef((d,), (None,), "normal", dt),
        "wr": ParamDef((d, d), (FSDP_AXIS, TP_AXIS), "fan_in", dt),
        "wk": ParamDef((d, d), (FSDP_AXIS, TP_AXIS), "fan_in", dt),
        "wv": ParamDef((d, d), (FSDP_AXIS, TP_AXIS), "fan_in", dt),
        "wg": ParamDef((d, d), (FSDP_AXIS, TP_AXIS), "fan_in", dt),
        "w0": ParamDef((d,), (None,), "normal", "float32"),
        "w_lora_a": ParamDef((d, r), (FSDP_AXIS, None), "fan_in", "float32"),
        "w_lora_b": ParamDef((r, d), (None, TP_AXIS), "fan_in", "float32"),
        "bonus_u": ParamDef((h, hd), (TP_AXIS, None), "normal", "float32"),
        "ln_x": ParamDef((d,), (None,), "ones", dt),
        "wo": ParamDef((d, d), (TP_AXIS, FSDP_AXIS), "fan_in", dt),
        # channel-mix
        "cmu_k": ParamDef((d,), (None,), "normal", dt),
        "cmu_r": ParamDef((d,), (None,), "normal", dt),
        "ck": ParamDef((d, f), (FSDP_AXIS, TP_AXIS), "fan_in", dt),
        "cv": ParamDef((f, d), (TP_AXIS, FSDP_AXIS), "fan_in", dt),
        "cr": ParamDef((d, d), (FSDP_AXIS, TP_AXIS), "fan_in", dt),
    }


def _token_shift(x: torch.Tensor, state: Optional[torch.Tensor]):
    """x_{t-1} per position; ``state`` carries the last token across calls."""
    if state is None:
        state = torch.zeros_like(x[:, :1])
    prev = torch.cat([state[:, None] if state.dim() == 2 else state, x[:, :-1]], dim=1)
    return prev, x[:, -1]


def _lerp(x, prev, mu):
    return x + (prev - x) * mu.to(x.dtype)


def _heads(x: torch.Tensor, b: int, t: int, h: int, hd: int) -> torch.Tensor:
    """[B, T, H·hd] → contiguous f32 [B, H, T, hd], the kernel's layout."""
    return split_heads(x, h).float().contiguous()


def rwkv_time_mix(params, x, cfg, *, shift_state: Optional[torch.Tensor] = None,
                  wkv_state: Optional[torch.Tensor] = None, return_state: bool = False):
    b, t, d = x.shape
    h, hd = cfg.rwkv_heads, cfg.rwkv_head_dim
    cdt = torch_dtype(cfg.compute_dtype)

    prev, last = _token_shift(x, shift_state)
    xr = _lerp(x, prev, params["mu_r"])
    xk = _lerp(x, prev, params["mu_k"])
    xv = _lerp(x, prev, params["mu_v"])
    xw = _lerp(x, prev, params["mu_w"])
    xg = _lerp(x, prev, params["mu_g"])

    r = _heads(xr @ params["wr"].to(cdt), b, t, h, hd)
    k = _heads(xk @ params["wk"].to(cdt), b, t, h, hd)
    v = _heads(xv @ params["wv"].to(cdt), b, t, h, hd)
    g = F.silu(xg @ params["wg"].to(cdt))

    # data-dependent decay (Finch), in f32: w = exp(-exp(w0 + lora(x̃)))
    lora = torch.tanh(xw.float() @ params["w_lora_a"]) @ params["w_lora_b"]
    logw = params["w0"][None, None] + lora                        # [B, T, D]
    w = _heads(torch.exp(-torch.exp(logw)), b, t, h, hd)

    r = constrain(r, BATCH_AXES, TP_AXIS, None, None)
    k = constrain(k, BATCH_AXES, TP_AXIS, None, None)
    v = constrain(v, BATCH_AXES, TP_AXIS, None, None)
    w = constrain(w, BATCH_AXES, TP_AXIS, None, None)

    if wkv_state is None:
        wkv_state = torch.zeros((b, h, hd, hd), dtype=torch.float32, device=x.device)
    scan = rwkv6_diff if torch.is_grad_enabled() else rwkv6

    def run(r, k, v, w, u, s0):
        return scan(r.contiguous(), k.contiguous(), v.contiguous(), w.contiguous(),
                    u.contiguous(), s0.contiguous())

    mesh = active_mesh()
    if mesh is None:
        o, s_fin = run(r, k, v, w, params["bonus_u"], wkv_state)
    else:   # the kernel on each rank's local heads
        heads = fit_entry(TP_AXIS, h)
        spec = P(fit_entry(BATCH_AXES, b), heads, None, None)
        o, s_fin = shard_map(run, mesh=mesh, in_specs=(spec,) * 4 + (P(heads, None), spec),
                             out_specs=(spec, spec))(r, k, v, w, params["bonus_u"], wkv_state)
    o = o.transpose(1, 2).reshape(b, t, d)

    # per-head group norm (ln_x), then gate
    of = o.float().reshape(b, t, h, hd)
    var = (of * of).mean(dim=-1, keepdim=True)
    of = of * torch.rsqrt(var + LN_X_EPS)
    # the head split above takes its gradient in o's placements: heads that
    # do not divide the model axis are replicated, the gradient of the gated
    # product is not
    o = (grad_in_placements(of.reshape(b, t, d)) * params["ln_x"][None, None].float()).to(cdt)
    out = constrain((o * g) @ params["wo"].to(cdt), BATCH_AXES, None, None)
    if return_state:
        return out, (last, s_fin)
    return out


def rwkv_channel_mix(params, x, cfg, *, shift_state: Optional[torch.Tensor] = None,
                     return_state: bool = False):
    cdt = torch_dtype(cfg.compute_dtype)
    prev, last = _token_shift(x, shift_state)
    xk = _lerp(x, prev, params["cmu_k"])
    xr = _lerp(x, prev, params["cmu_r"])
    kk = torch.square(F.relu(xk @ params["ck"].to(cdt)))
    kk = constrain(kk, BATCH_AXES, None, TP_AXIS)
    vv = kk @ params["cv"].to(cdt)
    rr = torch.sigmoid(xr @ params["cr"].to(cdt))
    out = constrain(rr * vv, BATCH_AXES, None, None)
    if return_state:
        return out, last
    return out
