"""Model substrate of the port: configs, layers, and the decoder-only family.

:func:`build_model` materializes a :class:`CausalLM` on the target device
(the card by default).  Ported block kinds: attention with a dense MLP, and
RWKV6, with every attention option (``attn_naive``, ``flash_bwd``).  MoE,
mamba/hybrid, encoder-decoder and frontend configs resolve
(``repro_torch.configs``) but raise here.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.device import DeviceLike, resolve_device

from .blocks import NOT_PORTED
from .config import SHAPES, ArchConfig, ShapeConfig, dtype_name, torch_dtype
from .lm import CausalLM

def build_model(cfg: ArchConfig, *, device: DeviceLike = "cuda",
                dtype: Optional[torch.dtype] = None,
                generator: Optional[torch.Generator] = None) -> CausalLM:
    """A seeded :class:`CausalLM` with its parameters on ``device``.

    ``dtype`` overrides the config's parameter and compute dtypes (the f32
    decay parameters of RWKV stay f32).  The parameters are seeded from one
    draw of ``generator`` (seed 0 without one), each leaf from its own
    stable seed, so a model is the same in every process.
    """
    dev = resolve_device(device)
    if cfg.is_encdec:
        raise NotImplementedError(f"encoder-decoder models ({cfg.name}) are {NOT_PORTED}")
    if cfg.frontend:
        raise NotImplementedError(f"{cfg.frontend} frontends ({cfg.name}) are {NOT_PORTED}")
    if dtype is not None:
        name = dtype_name(dtype)
        cfg = dataclasses.replace(cfg, param_dtype=name, compute_dtype=name)
    seed = 0 if generator is None else int(
        torch.randint(0, 2 ** 62, (1,), generator=generator))
    return CausalLM(cfg, device=dev, seed=seed)


__all__ = ["ArchConfig", "CausalLM", "SHAPES", "ShapeConfig", "build_model", "torch_dtype"]
