"""Gated MLP (SwiGLU / GeGLU): the port's ``repro.models.mlp``."""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from .config import torch_dtype
from .layers import ParamDef


def mlp_defs(cfg, d_ff: int = 0) -> Dict[str, ParamDef]:
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    dt = cfg.param_dtype
    return {
        "wg": ParamDef((d, f), "fan_in", dt),
        "wu": ParamDef((d, f), "fan_in", dt),
        "wd": ParamDef((f, d), "fan_in", dt),
    }


def _act(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "geglu":
        return F.gelu(x, approximate="tanh")  # jax.nn.gelu(approximate=True)
    return F.silu(x)  # swiglu


def mlp(params, x: torch.Tensor, cfg) -> torch.Tensor:
    cdt = torch_dtype(cfg.compute_dtype)
    g = x @ params["wg"].to(cdt)
    u = x @ params["wu"].to(cdt)
    h = _act(g, cfg.activation) * u
    return h @ params["wd"].to(cdt)
