"""Carry parameter trees between the packages: ``params_from_jax`` and
``params_to_jax``.

The JAX package stacks its layers: ``CausalLM`` keeps each pattern
position's block parameters stacked over periods
(``params["blocks"]["pos{j}"][...][p]``), ``EncDecLM`` each stack's layers
(``params["encoder"][...][l]``, ``params["decoder"][...][l]``).  The port
keeps one module per layer (``blocks.{p·period + j}``, ``encoder.{l}``,
``decoder.{l}``).  Both store a weight as ``[d_in, d_out]`` (an expert's
``[E, d_in, d_out]``) and compute ``x @ W``, so every leaf carries over as
it is; the other leaves (``embed``, ``final_norm``, ``frontend``,
``enc_norm``) keep their paths.  The tree comes in as numpy arrays
(``jax.tree.map(np.asarray, params)``); this module imports neither JAX nor
the JAX package.

:func:`params_to_jax` is the inverse, so the trainer keeps its checkpoints
in JAX's layout (``params``, ``opt_m``, ``opt_v``: each a stacked tree) and
each package resumes the other's.  A bf16 leaf leaves as numpy's 2-byte
void type ``V2``, the bytes and type ``np.savez`` writes for JAX's bf16
arrays, and comes back through ``params_from_jax`` as bf16.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from .blocks import layer_pattern
from .config import ArchConfig
from .layers import flatten_tree

__all__ = ["params_from_jax", "params_to_jax", "shapes_to_jax", "specs_to_jax"]

_BF16_BYTES = np.dtype("V2")   # how an npz holds a bf16 array


def _tensor(a: Any) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: widen, exact
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    if a.dtype == _BF16_BYTES:       # a bf16 leaf read back from an npz
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))  # a writable copy


def _layer_slots(cfg: ArchConfig):
    """``{port stack name: [(JAX path, index in its stacked leaves)] per layer}``."""
    if cfg.is_encdec:
        return {name: [([name], l) for l in range(n)]
                for name, n in (("encoder", cfg.enc_layers), ("decoder", cfg.dec_layers))}
    pattern, n_periods = layer_pattern(cfg)
    period = len(pattern)
    return {"blocks": [(["blocks", f"pos{layer % period}"], layer // period)
                       for layer in range(n_periods * period)]}


def _node(tree: Dict[str, Any], path) -> Any:
    for name in path:
        tree = tree[name]
    return tree


def params_from_jax(cfg: ArchConfig, params_np: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX ``CausalLM`` or ``EncDecLM`` parameter tree (numpy leaves) as
    the port's ``state_dict`` (CPU tensors in the JAX dtypes;
    ``load_state_dict`` copies them to the model's device and dtype)."""
    slots = _layer_slots(cfg)
    flat = flatten_tree({k: v for k, v in params_np.items() if k not in slots})
    for name, layers in slots.items():
        for layer, (path, i) in enumerate(layers):
            for key, leaf in flatten_tree(_node(params_np, path)).items():
                flat[f"{name}.{layer}.{key}"] = np.asarray(leaf)[i]
    return {k: _tensor(v) for k, v in flat.items()}


def _numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(_BF16_BYTES)
    return t.numpy()


def _to_jax(cfg: ArchConfig, state: Mapping[str, Any], leaf, stack) -> Dict[str, Any]:
    slots = _layer_slots(cfg)
    tree: Dict[str, Any] = {}

    def put(path, val):
        node = tree
        for name in path[:-1]:
            node = node.setdefault(name, {})
        node[path[-1]] = val

    groups: Dict[tuple, Dict[int, Any]] = {}   # (JAX path, leaf key) → {index: leaf}
    for key, t in state.items():
        parts = key.split(".")
        if parts[0] in slots:
            path, i = slots[parts[0]][int(parts[1])]
            groups.setdefault((tuple(path), ".".join(parts[2:])), {})[i] = t
        else:
            put(parts, leaf(t))
    for (path, key), leaves in groups.items():
        put([*path, *key.split(".")], stack([leaf(leaves[i]) for i in sorted(leaves)]))
    return tree


def params_to_jax(cfg: ArchConfig, state: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """The port's ``state_dict`` (or any dict keyed like it, e.g. AdamW
    moments) as the JAX tree: numpy leaves on the host, layer leaves stacked
    as JAX stacks them (``[n_periods, ...]`` under ``blocks/pos{j}``,
    ``[n_layers, ...]`` under ``encoder`` and ``decoder``)."""
    return _to_jax(cfg, state, _numpy, np.stack)


def _stack_specs(specs):
    if any(sp != specs[0] for sp in specs):
        raise ValueError(f"the layers of one stacked leaf have different specs: {set(specs)}")
    return type(specs[0])(None, *specs[0])


def specs_to_jax(cfg: ArchConfig, specs: Mapping[str, Any]) -> Dict[str, Any]:
    """The port's ``param_specs()`` as JAX's ``param_specs()`` tree."""
    return _to_jax(cfg, specs, lambda sp: sp, _stack_specs)


def shapes_to_jax(cfg: ArchConfig, shapes: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """The port's ``param_shapes()`` (meta tensors) as JAX's ``param_shapes()``
    tree: meta tensors of the stacked leaves' shapes and dtypes."""
    return _to_jax(cfg, shapes, lambda t: t, torch.stack)
