"""Optimizers + schedules: AdamW, the port's ``repro.train.optimizer``.

The update math runs in f32 on f32 copies of every gradient and parameter
(global-norm clipping first), and the result is cast back to the
parameter's dtype; the moments are kept in ``moment_dtype``
(``"bfloat16"`` halves their memory) and the learning rate is computed in
f32, all as in JAX.  ``torch.optim.AdamW`` is not that function: on bf16
parameters it keeps bf16 moments and updates in bf16.

Trees are dicts of tensors keyed like ``named_parameters()``.  The port
updates parameters and moments in place (a full-width model's f32 moments
alone are ~9 GB; JAX donates its buffers to the same end) and returns them
with a new step count.

Sharded trees (DTensors, gradients in their parameters' placements): the
moments are made in the parameters' placements, the clipping norm is the
global one (:func:`global_sq_norm`), and the update runs on each rank's
local shards, elementwise, so it equals the unsharded update.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, NamedTuple, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.models.config import torch_dtype

Tree = Dict[str, torch.Tensor]

__all__ = ["AdamW", "AdamWState", "constant_schedule", "cosine_schedule", "global_sq_norm"]


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if isinstance(t, DTensor) else t


def global_sq_norm(grads: Tree) -> torch.Tensor:
    """Σ g² over every element of every gradient, in f32.  A DTensor counts
    each of its elements once: its local sum, on the ranks at coordinate 0
    of every mesh dim it is replicated over (zero elsewhere), summed by one
    ``all_reduce`` over the world."""
    total, sharded = None, False
    for g in grads.values():
        loc = _local(g).float()
        part = torch.sum(loc * loc)
        if isinstance(g, DTensor):
            sharded = True
            mesh = g.device_mesh
            coords = mesh.get_coordinate()
            if any(isinstance(p, Replicate) and c != 0 for p, c in zip(g.placements, coords)):
                part = torch.zeros_like(part)
        total = part if total is None else total + part
    if sharded:
        dist.all_reduce(total)
    return total


class AdamWState(NamedTuple):
    step: torch.Tensor   # 0-d int32
    m: Tree
    v: Tree


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Callable[[torch.Tensor], torch.Tensor]
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: str = "float32"

    def init(self, params: Tree) -> AdamWState:
        dt = torch_dtype(self.moment_dtype)
        zeros = lambda: {k: torch.zeros_like(p, dtype=dt)  # noqa: E731
                         for k, p in params.items()}
        device = next(iter(params.values())).device
        return AdamWState(torch.zeros((), dtype=torch.int32, device=device), zeros(), zeros())

    @torch.no_grad()
    def update(self, grads: Tree, state: AdamWState, params: Tree
               ) -> Tuple[Tree, AdamWState, torch.Tensor]:
        """Returns (params, new_state, grad_norm); ``params`` and the
        moments are updated in place."""
        gnorm = torch.sqrt(global_sq_norm(grads))
        scale = None
        if self.grad_clip:
            scale = torch.clamp_max(self.grad_clip / torch.clamp_min(gnorm, 1e-9), 1.0)
        step = state.step + 1
        lr = self.lr(step)
        c1 = 1.0 - self.b1 ** step.float()
        c2 = 1.0 - self.b2 ** step.float()
        for key, p in params.items():
            g = _local(grads[key]).float()
            if scale is not None:
                g = g * scale
            p, m, v = _local(p), _local(state.m[key]), _local(state.v[key])
            mf = self.b1 * m.float() + (1 - self.b1) * g
            vf = self.b2 * v.float() + (1 - self.b2) * g * g
            mh = mf / c1
            vh = vf / c2
            pf = p.float()
            delta = mh / (torch.sqrt(vh) + self.eps) + self.weight_decay * pf
            p.copy_(pf - lr * delta)
            m.copy_(mf)
            v.copy_(vf)
        return params, AdamWState(step, state.m, state.v), gnorm


def cosine_schedule(peak_lr: float, warmup: int, total: int, floor: float = 0.1):
    """Linear warmup to ``peak_lr``, then a cosine to ``floor``·peak at
    ``total``; f32 in, f32 out."""
    def lr(step: torch.Tensor) -> torch.Tensor:
        s = step.float()
        warm = peak_lr * s / max(warmup, 1)
        frac = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = peak_lr * (floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * frac)))
        return torch.where(s < warmup, warm, cos)

    return lr


def constant_schedule(value: float):
    return lambda step: torch.full((), value, dtype=torch.float32, device=step.device)
