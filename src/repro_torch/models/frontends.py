"""Modality frontends, stubbed as in the JAX package (``repro.models.frontends``).

``[vlm]`` / ``[audio]`` architectures specify the transformer backbone only;
the inputs carry *precomputed* patch or frame embeddings.  The stub is one
learned projection from the frontend feature width to ``d_model``, computed
in the compute dtype.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.distributed.api import BATCH_AXES, FSDP_AXIS, constrain

from .config import torch_dtype
from .layers import ParamDef


def frontend_defs(cfg) -> Dict[str, ParamDef]:
    return {"proj": ParamDef((cfg.frontend_dim, cfg.d_model), (None, FSDP_AXIS), "fan_in",
                             cfg.param_dtype)}


def project_frontend(params, feats: torch.Tensor, cfg) -> torch.Tensor:
    """feats [B, P, frontend_dim] → [B, P, D] prefix embeddings."""
    cdt = torch_dtype(cfg.compute_dtype)
    feats = constrain(feats, BATCH_AXES, None, None)      # an input: placed under a mesh
    return constrain(feats.to(cdt) @ params["proj"].to(cdt), BATCH_AXES, None, None)
