"""Modality frontends, stubbed as in the JAX package (``repro.models.frontends``).

``[vlm]`` / ``[audio]`` architectures specify the transformer backbone only;
the inputs carry *precomputed* patch or frame embeddings.  The stub is one
learned projection from the frontend feature width to ``d_model``, computed
in the compute dtype.
"""
from __future__ import annotations

from typing import Dict

import torch

from .config import torch_dtype
from .layers import ParamDef


def frontend_defs(cfg) -> Dict[str, ParamDef]:
    return {"proj": ParamDef((cfg.frontend_dim, cfg.d_model), "fan_in", cfg.param_dtype)}


def project_frontend(params, feats: torch.Tensor, cfg) -> torch.Tensor:
    """feats [B, P, frontend_dim] → [B, P, D] prefix embeddings."""
    cdt = torch_dtype(cfg.compute_dtype)
    return feats.to(cdt) @ params["proj"].to(cdt)
