"""Layer stack: the period pattern over blocks, full-sequence and decode.

The port's ``repro.models.blocks``.  The JAX package stacks each pattern
position's parameters over periods and scans; the port keeps one
:class:`Block` module per layer (layer ``l`` is period ``l // period`` at
pattern position ``l % period``) and loops over them.  ``layer_pattern`` is
kept so the cache layout stays the JAX one: ``{"pos{j}": {leaf: [n_periods,
B, ...]}}``.  Every block kind of the JAX package: ``attn`` and ``mamba``,
each with a dense MLP or an MoE feed-forward, and ``rwkv``.

Training recomputes activations as JAX's ``run_stack_full`` does
(``cfg.remat``, with ``torch.utils.checkpoint``, non-reentrant) whenever
grad is enabled: ``remat_policy`` ``nothing`` saves a period's input only
and recomputes the period in the backward, ``per_block`` the same a block
at a time, ``dots`` also keeps the outputs of the plain matrix products
(``aten.mm``/``addmm``, JAX's ``dots_with_no_batch_dims_saveable``).
Recompute changes memory, never values.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.distributed.api import active_mesh, place_like, use_mesh

from .attention import attn_defs, self_attention_decode, self_attention_full
from .layers import ParamTree, norm_def, rms_norm
from .mlp import mlp, mlp_defs
from .moe import moe, moe_defs
from .rwkv import rwkv_channel_mix, rwkv_defs, rwkv_time_mix
from .ssm import mamba, mamba_defs


def layer_pattern(cfg) -> Tuple[List[Tuple[str, bool]], int]:
    """[(kind, is_moe)] over one period + the period count."""
    kinds = cfg.block_kinds()
    period = 1
    if cfg.attn_every:
        period = math.lcm(period, cfg.attn_every)
    if cfg.n_experts:
        period = math.lcm(period, cfg.moe_every)
    assert cfg.n_layers % period == 0, (cfg.n_layers, period)
    pattern = [(kinds[i], cfg.layer_is_moe(i) and kinds[i] != "rwkv") for i in range(period)]
    return pattern, cfg.n_layers // period


def block_defs(cfg, kind: str, is_moe: bool) -> Dict[str, Any]:
    """ParamDefs of one block (pre-norms + mixer + feed-forward)."""
    defs: Dict[str, Any] = {"norm1": norm_def(cfg)}
    if kind == "rwkv":
        # rwkv block = time-mix + channel-mix, no separate mlp
        defs["time_mix"] = rwkv_defs(cfg)
        defs["norm2"] = norm_def(cfg)
        return defs
    if kind == "mamba":
        defs["mamba"] = mamba_defs(cfg)
    else:
        defs["attn"] = attn_defs(cfg)
    defs["norm2"] = norm_def(cfg)
    defs["ffn"] = moe_defs(cfg) if is_moe else mlp_defs(cfg)
    return defs


class Block(ParamTree):
    """One layer's parameters and its two paths."""

    def __init__(self, cfg, kind: str, is_moe: bool, *, device: torch.device,
                 seed: int, prefix: str):
        super().__init__(block_defs(cfg, kind, is_moe), device=device, seed=seed,
                         prefix=prefix)
        self.cfg, self.kind, self.is_moe = cfg, kind, is_moe

    def _ffn(self, x):
        h2 = rms_norm(x, self["norm2"], self.cfg.norm_eps)
        return x + (moe if self.is_moe else mlp)(self["ffn"], h2, self.cfg)

    def full(self, x, positions, *, window=None, collect_cache: bool = False):
        """Full-sequence path.  Returns (x, cache leaf dict or None)."""
        cfg = self.cfg
        h = rms_norm(x, self["norm1"], cfg.norm_eps)
        if self.kind == "rwkv":
            o, (tm_last, wkv) = rwkv_time_mix(self["time_mix"], h, cfg, return_state=True)
            x = x + o
            h2 = rms_norm(x, self["norm2"], cfg.norm_eps)
            o2, cm_last = rwkv_channel_mix(self["time_mix"], h2, cfg, return_state=True)
            cache = {"tm_shift": tm_last, "wkv": wkv, "cm_shift": cm_last}
            return x + o2, (cache if collect_cache else None)
        if self.kind == "mamba":
            o, (conv_s, ssm_s) = mamba(self["mamba"], h, cfg, return_state=True)
            cache = {"conv": conv_s, "ssm": ssm_s}
        else:
            o, (k, v) = self_attention_full(self["attn"], h, positions, cfg, window=window,
                                            return_kv=True)
            cache = {"k": k, "v": v}
        return self._ffn(x + o), (cache if collect_cache else None)

    def decode(self, x, cache: Dict[str, torch.Tensor], lengths, *, window=None):
        """One decode step.  Attention writes its KV cache in place; RWKV and
        Mamba return their new states.  Returns (x, the cache leaves to
        replace)."""
        cfg = self.cfg
        h = rms_norm(x, self["norm1"], cfg.norm_eps)
        if self.kind == "rwkv":
            o, (tm_last, wkv) = rwkv_time_mix(
                self["time_mix"], h, cfg, shift_state=cache["tm_shift"],
                wkv_state=cache["wkv"], return_state=True)
            x = x + o
            h2 = rms_norm(x, self["norm2"], cfg.norm_eps)
            o2, cm_last = rwkv_channel_mix(self["time_mix"], h2, cfg,
                                           shift_state=cache["cm_shift"], return_state=True)
            return x + o2, {"tm_shift": tm_last, "wkv": wkv, "cm_shift": cm_last}
        if self.kind == "mamba":
            o, (conv_s, ssm_s) = mamba(self["mamba"], h, cfg, conv_state=cache["conv"],
                                       ssm_state=cache["ssm"], return_state=True)
            return self._ffn(x + o), {"conv": conv_s, "ssm": ssm_s}
        o, _, _ = self_attention_decode(self["attn"], h, cfg, cache["k"], cache["v"],
                                        lengths, window=window)
        return self._ffn(x + o), {}


_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def remat_fn(fn):
    """``fn`` bound to the active mesh: a checkpoint's recompute runs in the
    backward, which autograd runs on a device thread for CUDA tensors, where
    the context variable of :func:`use_mesh` is unset."""
    mesh = active_mesh()
    if mesh is None:
        return fn

    def run(*args):
        with use_mesh(mesh):
            return fn(*args)
    return run


def _remat(fn, cfg, x):
    """``fn(x)`` under activation checkpointing by ``cfg.remat_policy``."""
    fn = remat_fn(fn)
    if cfg.remat_policy == "dots":
        return checkpoint(fn, x, use_reentrant=False,
                          context_fn=functools.partial(create_selective_checkpoint_contexts,
                                                       _save_dots))
    return checkpoint(fn, x, use_reentrant=False)


def run_stack_full(blocks, x, positions, cfg, *, window=None, collect_cache: bool = False
                   ) -> Tuple[torch.Tensor, Optional[List[Dict[str, torch.Tensor]]]]:
    """Every layer in order.  Returns (x, per-layer cache leaves or None).

    With ``cfg.remat`` and grad enabled, each period (``per_block``: each
    block) runs under :func:`_remat`; the cache is not collected there."""
    if cfg.remat and torch.is_grad_enabled() and not collect_cache:
        period = len(layer_pattern(cfg)[0])
        groups = ([[blk] for blk in blocks] if cfg.remat_policy == "per_block"
                  else [blocks[i:i + period] for i in range(0, len(blocks), period)])

        def body(group, h):
            for blk in group:
                h, _ = blk.full(h, positions, window=window)
            return h

        for group in groups:
            x = _remat(functools.partial(body, group), cfg, x)
        return x, None
    caches = []
    for blk in blocks:
        x, c = blk.full(x, positions, window=window, collect_cache=collect_cache)
        caches.append(c)
    return x, (caches if collect_cache else None)


def run_stack_decode(blocks, x, cfg, caches, lengths, *, window=None):
    """One decode step through every layer; ``caches`` (the stacked JAX
    layout) is updated in place and returned."""
    pattern, _ = layer_pattern(cfg)
    period = len(pattern)
    for layer, blk in enumerate(blocks):
        p, j = divmod(layer, period)
        leaves = caches[f"pos{j}"]
        x, updates = blk.decode(x, {k: leaf[p] for k, leaf in leaves.items()}, lengths,
                                window=window)
        for k, val in updates.items():
            dst = leaves[k][p]
            dst.copy_(place_like(val, dst))
    return x, caches
