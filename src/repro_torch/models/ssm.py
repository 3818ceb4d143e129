"""Mamba (selective SSM) block: the Jamba hybrid's attention-free layer.

The port of ``repro.models.ssm``, the Mamba-1 recurrence
(arXiv:2312.00752):

    h_t = exp(Δ_t ⊙ A) ⊙ h_{t-1} + (Δ_t x_t) ⊗ B_t          h ∈ R^{Di × Ds}
    y_t = h_t · C_t + D ⊙ x_t

As in JAX, a chunked scan: chunks of ``chunk`` tokens (the tail chunk padded
with ``a = 1``, ``bu = 0``) in order, carrying ``h``, with a log-depth scan
inside a chunk under JAX's combine ``(a_l·a_r, b_l·a_r + b_r)``.  PyTorch has
no ``associative_scan``: inside a chunk it is a doubling (Hillis–Steele)
scan, log₂L passes of whole-chunk tensor operations, not L launches.  The
order of the f32 products differs from ``lax.associative_scan``'s; the
values agree within f32 rounding.

:func:`mamba` forms the decays and inputs ``[B, L, Di, Ds]`` of one chunk
at a time and contracts the chunk's states with ``C`` before the next: JAX
materializes ``h_all [B, T, Di, Ds]`` for the whole sequence (1.07 GB in
f32 at jamba's width and T 1,024).  The values are the same.  The scan is
plain PyTorch on either device, as it is plain JAX in the reference.

Sharding as in JAX: the inner width Di over ``model``, the batch over the
data axes; the scan is elementwise over (B, Di), so it runs on DTensors as
they are.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.api import BATCH_AXES, FSDP_AXIS, TP_AXIS, constrain

from .config import torch_dtype
from .layers import ParamDef


def mamba_defs(cfg) -> Dict[str, ParamDef]:
    d, di, ds, r, kc = cfg.d_model, cfg.ssm_d_inner, cfg.ssm_d_state, cfg.dt_rank, cfg.ssm_d_conv
    dt = cfg.param_dtype
    return {
        "in_proj": ParamDef((d, 2 * di), (FSDP_AXIS, TP_AXIS), "fan_in", dt),
        "conv_w": ParamDef((kc, di), (None, TP_AXIS), "fan_in", dt),
        "conv_b": ParamDef((di,), (TP_AXIS,), "zeros", dt),
        "x_proj": ParamDef((di, r + 2 * ds), (TP_AXIS, None), "fan_in", dt),
        "dt_proj": ParamDef((r, di), (None, TP_AXIS), "fan_in", dt),
        "dt_bias": ParamDef((di,), (TP_AXIS,), "zeros", "float32"),
        "a_log": ParamDef((di, ds), (TP_AXIS, None), "ones", "float32"),
        "d_skip": ParamDef((di,), (TP_AXIS,), "ones", "float32"),
        "out_proj": ParamDef((di, d), (TP_AXIS, FSDP_AXIS), "fan_in", dt),
    }


def _depthwise_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                    state: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Causal depthwise conv over the sequence.  x [B, T, Di], w [K, Di].

    Returns (y [B, T, Di], new_state [B, K-1, Di]): the state carries the
    last K-1 inputs for decode continuation, in x's dtype.
    """
    k, t = w.shape[0], x.shape[1]
    if state is None:
        state = constrain(torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                                      device=x.device), BATCH_AXES, None, TP_AXIS)
    xp = torch.cat([state.to(x.dtype), x], dim=1)                 # [B, K-1+T, Di]
    y = xp[:, 0:t] * w[0]
    for i in range(1, k):                                         # JAX's order of the sum
        y = y + xp[:, i:i + t] * w[i]
    return y + b.to(y.dtype), xp[:, xp.shape[1] - (k - 1):]


def _scan_chunk(a: torch.Tensor, bu: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inclusive prefix of (a, bu) [B, L, Di, Ds] along axis 1 under
    ``(a_l·a_r, b_l·a_r + b_r)``: the doubling scan, log₂L passes."""
    step = 1
    while step < a.shape[1]:
        a_r = a[:, step:]
        bu = torch.cat([bu[:, :step], bu[:, :-step] * a_r + bu[:, step:]], dim=1)
        a = torch.cat([a[:, :step], a[:, :-step] * a_r], dim=1)
        step *= 2
    return a, bu


def _ssm_chunk_scan(a: torch.Tensor, bu: torch.Tensor, h0: torch.Tensor, chunk: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Prefix recurrence h_t = a_t ⊙ h_{t-1} + bu_t over [B, T, Di, Ds].

    Chunks of ``min(chunk, T)`` in order, carrying h; the tail padded with
    a = 1.  Returns (h_all [B, T, Di, Ds], h_final [B, Di, Ds]).
    """
    t = a.shape[1]
    l = min(chunk, t)
    pad = -(-t // l) * l - t
    if pad:
        a = F.pad(a, (0, 0, 0, 0, 0, pad), value=1.0)
        bu = F.pad(bu, (0, 0, 0, 0, 0, pad))
    h, outs = h0, []
    for c0 in range(0, t + pad, l):
        pa, pb = _scan_chunk(a[:, c0:c0 + l], bu[:, c0:c0 + l])
        h_all = pa * h[:, None] + pb                              # h_t = A_t h0 + B_t
        h = h_all[:, -1]
        outs.append(h_all)
    return torch.cat(outs, dim=1)[:, :t], h


def mamba(params, x: torch.Tensor, cfg, *,
          conv_state: Optional[torch.Tensor] = None,
          ssm_state: Optional[torch.Tensor] = None,
          return_state: bool = False, chunk: int = 256):
    """x [B, T, D] → [B, T, D] (+ (conv_state, ssm_state) with ``return_state``)."""
    bsz, t, _ = x.shape
    di, ds, r = cfg.ssm_d_inner, cfg.ssm_d_state, cfg.dt_rank
    cdt = torch_dtype(cfg.compute_dtype)
    sdt = torch_dtype(cfg.ssm_compute_dtype)

    xz = constrain(x @ params["in_proj"].to(cdt), BATCH_AXES, None, TP_AXIS)
    xi, z = xz.chunk(2, dim=-1)                                   # [B, T, Di] each
    xi = constrain(xi, BATCH_AXES, None, TP_AXIS)
    xi, conv_state_new = _depthwise_conv(xi, params["conv_w"].to(cdt), params["conv_b"],
                                         conv_state)
    xi = constrain(F.silu(xi), BATCH_AXES, None, TP_AXIS)

    dbc = (xi @ params["x_proj"].to(cdt)).float()                 # [B, T, R+2Ds]
    dt_lo, b_ssm, c_ssm = torch.split(dbc, [r, ds, ds], dim=-1)
    dt = F.softplus(dt_lo @ params["dt_proj"].float() + params["dt_bias"])   # [B, T, Di]
    dt = constrain(dt, BATCH_AXES, None, TP_AXIS)
    a = -torch.exp(params["a_log"].float())                      # [Di, Ds]
    xf = xi.float()
    dtx = dt * xf

    if ssm_state is None:
        ssm_state = constrain(torch.zeros((bsz, di, ds), dtype=torch.float32, device=x.device),
                              BATCH_AXES, TP_AXIS, None)
    h = ssm_state.to(sdt)
    l = min(chunk, t)
    ys = []
    for c0 in range(0, t, l):               # one chunk's [B, L, Di, Ds] at a time
        sl = slice(c0, c0 + l)
        decay = torch.exp(dt[:, sl, :, None] * a).to(sdt)
        bu = (dtx[:, sl, :, None] * b_ssm[:, sl, None, :]).to(sdt)
        h_all, h = _ssm_chunk_scan(decay, bu, h, l)
        ys.append(torch.einsum("btis,bts->bti", h_all.float(), c_ssm[:, sl]))
    y = torch.cat(ys, dim=1) + params["d_skip"] * xf
    y = constrain(y.to(cdt) * F.silu(z), BATCH_AXES, None, TP_AXIS)
    out = constrain(y @ params["out_proj"].to(cdt), BATCH_AXES, None, None)
    if return_state:
        return out, (conv_state_new, h.float())
    return out
