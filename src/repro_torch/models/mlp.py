"""Gated MLP (SwiGLU / GeGLU), TP-sharded on the hidden axis: the port's
``repro.models.mlp``."""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.distributed.api import BATCH_AXES, FSDP_AXIS, TP_AXIS, constrain

from .config import torch_dtype
from .layers import ParamDef


def mlp_defs(cfg, d_ff: int = 0) -> Dict[str, ParamDef]:
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    dt = cfg.param_dtype
    return {
        "wg": ParamDef((d, f), (FSDP_AXIS, TP_AXIS), "fan_in", dt),
        "wu": ParamDef((d, f), (FSDP_AXIS, TP_AXIS), "fan_in", dt),
        "wd": ParamDef((f, d), (TP_AXIS, FSDP_AXIS), "fan_in", dt),
    }


def _act(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "geglu":
        return F.gelu(x, approximate="tanh")  # jax.nn.gelu(approximate=True)
    return F.silu(x)  # swiglu


def mlp(params, x: torch.Tensor, cfg) -> torch.Tensor:
    cdt = torch_dtype(cfg.compute_dtype)
    g = x @ params["wg"].to(cdt)
    u = x @ params["wu"].to(cdt)
    h = constrain(_act(g, cfg.activation) * u, BATCH_AXES, None, TP_AXIS)
    return constrain(h @ params["wd"].to(cdt), BATCH_AXES, None, None)
