"""GPipe pipeline parallelism over a ``pipe`` mesh axis.

The port of ``repro.distributed.pipeline_parallel``.  With S stages and M
microbatches the loop runs S-1+M ticks: on tick t stage s processes
microbatch t-s (stage 0 injects microbatch t, the last stage emits
microbatch t-(S-1)), and each tick the stage shift hands every activation
to the next stage around a ring (a ``batch_isend_irecv`` on the ``pipe``
group).  A stage whose tick falls in the fill or drain bubble computes
nothing and sends zeros (JAX computes on its masked input and discards the
result; no emitted value depends on it either way).  A final ``psum``
shares the last stage's outputs with every stage.

Differentiable, so :func:`pipeline_loss` trains: the schedule is one
autograd Function whose backward runs the ticks in reverse, shifting the
cotangents the other way (stage s+1 → s) and recomputing each stage's
forward from its saved input (GPipe's re-materialization).  Every rank
makes the same collectives in the same order in both passes, which a
backward left to the autograd engine's order per rank does not promise.
"""
from __future__ import annotations

from typing import Any, Callable

import torch
from torch.utils import _pytree as pytree

from .api import P, Mesh, _shift, psum, shard_map

Pytree = Any

__all__ = ["pipeline_apply", "pipeline_loss"]


class _GPipe(torch.autograd.Function):
    """(x_local [M, mb, ...], *this stage's param leaves) → the emitted
    outputs [M, mb, ...] on the last stage, zeros elsewhere."""

    @staticmethod
    def forward(ctx, run, x, *leaves):
        stage_fn, spec, mesh, axis = run
        n, s = mesh.shape[axis], mesh.coords[axis]
        m = x.shape[0]
        params = pytree.tree_unflatten(list(leaves), spec)
        ring = [(i, (i + 1) % n) for i in range(n)]
        buf, inputs, out = torch.zeros_like(x[0]), {}, torch.zeros_like(x)
        for t in range(n - 1 + m):
            if 0 <= t - s < m:
                inputs[t] = x[t] if s == 0 else buf
                y = stage_fn(params, inputs[t])
                if s == n - 1:
                    out[t - (n - 1)] = y
            else:                                  # fill / drain bubble
                y = torch.zeros_like(buf)
            buf = _shift(y, axis, ring, mesh)
        ctx.run, ctx.m, ctx.inputs = run, m, inputs
        ctx.save_for_backward(*leaves)
        return out

    @staticmethod
    def backward(ctx, g_out):
        stage_fn, spec, mesh, axis = ctx.run
        n, s, m = mesh.shape[axis], mesh.coords[axis], ctx.m
        leaves = [p.detach().requires_grad_(p.requires_grad) for p in ctx.saved_tensors]
        params = pytree.tree_unflatten(leaves, spec)
        back = [((i + 1) % n, i) for i in range(n)]
        g_leaves = [torch.zeros_like(p) for p in leaves]
        g_x = torch.zeros_like(g_out)
        g_buf = torch.zeros_like(g_out[0])        # the cotangent of this stage's next input
        for t in reversed(range(n - 1 + m)):
            g_y = _shift(g_buf, axis, back, mesh)
            g_buf = torch.zeros_like(g_buf)
            if not 0 <= t - s < m:
                continue
            if s == n - 1:
                g_y = g_y + g_out[t - (n - 1)]
            x_in = ctx.inputs[t].detach().requires_grad_()
            with torch.enable_grad():
                y = stage_fn(params, x_in)
            wrt = [x_in] + [p for p in leaves if p.requires_grad]
            grads = iter(torch.autograd.grad(y, wrt, g_y, allow_unused=True))
            g_in = next(grads)
            g_in = torch.zeros_like(x_in) if g_in is None else g_in
            for i, p in enumerate(leaves):
                if p.requires_grad:
                    gp = next(grads)
                    if gp is not None:
                        g_leaves[i] += gp
            if s == 0:
                g_x[t] = g_in
            else:
                g_buf = g_in
        return (None, g_x, *g_leaves)


def pipeline_apply(stage_fn: Callable, mesh: Mesh, *, axis: str = "pipe") -> Callable:
    """A pipelined apply: (stacked_params, xs [M, mb, ...]) → ys [M, mb, ...].

    ``stacked_params`` leaves carry a leading [S] stage dim (sharded over
    ``axis``); ``stage_fn(stage_params, x_micro)`` returns an activation of
    ``x_micro``'s shape.  Every rank gets the whole result as a plain tensor.
    """

    def local(params_local, x_local):
        leaves, spec = pytree.tree_flatten(params_local)
        out = _GPipe.apply((stage_fn, spec, mesh, axis), x_local, *(p[0] for p in leaves))
        return psum(out, axis)

    def pipelined(params_stacked, xs):
        specs = pytree.tree_map(lambda _: P(axis), params_stacked)
        ys = shard_map(local, mesh=mesh, in_specs=(specs, P()), out_specs=P())(params_stacked,
                                                                             xs)
        return ys.to_local()

    return pipelined


def pipeline_loss(stage_fn: Callable, loss_fn: Callable, mesh: Mesh, *,
                  axis: str = "pipe") -> Callable:
    """Differentiable pipelined loss: ``fn(stacked_params, xs, labels) =
    loss_fn(pipeline_apply(...)(stacked_params, xs), labels)``."""
    fwd = pipeline_apply(stage_fn, mesh, axis=axis)

    def fn(params_stacked, xs, labels):
        return loss_fn(fwd(params_stacked, xs), labels)

    return fn
