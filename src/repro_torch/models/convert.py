"""Carry a JAX parameter tree over to the port: ``params_from_jax``.

The JAX package keeps each pattern position's block parameters stacked over
periods (``params["blocks"]["pos{j}"][...][p]``); the port keeps one module
per layer (``blocks.{p·period + j}``).  Both store a weight as ``[d_in,
d_out]`` and compute ``x @ W``, so every leaf carries over as it is.  The
tree comes in as numpy arrays (``jax.tree.map(np.asarray, params)``); this
module imports neither JAX nor the JAX package.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .blocks import layer_pattern
from .config import ArchConfig

__all__ = ["params_from_jax"]


def _tensor(a: Any) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: widen, exact
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))  # a writable copy


def _flatten(tree: Dict[str, Any], prefix: str, out: Dict[str, Any]) -> None:
    for name, leaf in tree.items():
        key = f"{prefix}.{name}" if prefix else name
        if isinstance(leaf, dict):
            _flatten(leaf, key, out)
        else:
            out[key] = leaf


def params_from_jax(cfg: ArchConfig, params_np: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX ``CausalLM`` parameter tree (numpy leaves) as the port's
    ``state_dict`` (CPU tensors in the JAX dtypes; ``load_state_dict``
    copies them to the model's device and dtype)."""
    pattern, n_periods = layer_pattern(cfg)
    period = len(pattern)
    flat: Dict[str, Any] = {}
    _flatten({"embed": params_np["embed"], "final_norm": params_np["final_norm"]}, "", flat)
    for j in range(period):
        stacked: Dict[str, Any] = {}
        _flatten(params_np["blocks"][f"pos{j}"], "", stacked)
        for p in range(n_periods):
            for key, leaf in stacked.items():
                flat[f"blocks.{p * period + j}.{key}"] = np.asarray(leaf)[p]
    return {k: _tensor(v) for k, v in flat.items()}
