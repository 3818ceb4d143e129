"""Model substrate of the port: configs, layers, and the two model families.

:func:`build_model` materializes a :class:`CausalLM` (decoder-only: dense,
MoE, the Mamba hybrid, RWKV6, with or without a vision frontend) or, for an
encoder-decoder config, an :class:`EncDecLM`, on the target device (the card
by default), as ``repro.models.build_model`` picks its family.  The
parameters' values never depend on a mesh; a model runs sharded once its
parameters are placed (``model.shard(mesh)``) and it is called under
``use_mesh``.  ``moe_weight_stationary`` selects the weight-stationary MoE
island under a mesh with a model group that divides the experts, and the
local path otherwise, as in JAX.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from repro_torch.device import DeviceLike, resolve_device

from .config import SHAPES, ArchConfig, ShapeConfig, dtype_name, torch_dtype
from .encdec import EncDecLM
from .lm import CausalLM


def build_model(cfg: ArchConfig, *, device: DeviceLike = "cuda",
                dtype: Optional[torch.dtype] = None,
                generator: Optional[torch.Generator] = None) -> Union[CausalLM, EncDecLM]:
    """A seeded :class:`CausalLM` or :class:`EncDecLM` with its parameters
    on ``device``.

    ``dtype`` overrides the config's parameter and compute dtypes (the f32
    leaves of RWKV's decay and Mamba's ``a_log``, ``dt_bias`` and ``d_skip``
    stay f32).  The parameters are seeded from one draw of ``generator``
    (seed 0 without one), each leaf from its own stable seed, so a model is
    the same in every process.
    """
    dev = resolve_device(device)
    if dtype is not None:
        name = dtype_name(dtype)
        cfg = dataclasses.replace(cfg, param_dtype=name, compute_dtype=name)
    seed = 0 if generator is None else int(
        torch.randint(0, 2 ** 62, (1,), generator=generator))
    return (EncDecLM if cfg.is_encdec else CausalLM)(cfg, device=dev, seed=seed)


__all__ = ["ArchConfig", "CausalLM", "EncDecLM", "SHAPES", "ShapeConfig", "build_model",
           "torch_dtype"]
