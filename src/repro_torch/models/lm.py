"""CausalLM: the decoder-only model family, as an ``nn.Module``.

The port's ``repro.models.lm``.  Entry points:

* ``forward(batch)`` — logits for a full sequence; ``batch`` is JAX's dict
  (``{"tokens": [B, S], ...}``, with ``"frontend_feats"`` [B, P, F] for a
  frontend config: their projection overwrites positions [0, P) of the
  embeddings) or the token tensor itself.
* ``loss(batch)`` — (mean token NLL, metrics) against ``batch["labels"]``,
  over ``batch["loss_mask"]`` where given (the training objective).
* ``prefill(batch, cache_len)`` — full forward that also returns the
  serving cache and the lengths; ``batch`` as for ``forward`` (the serving
  engine passes the bare token tensor, as JAX's passes tokens only).
* ``decode(cache, tokens, lengths)`` — one incremental step against the
  cache.  The cache is updated in place (the JAX package returns a new one;
  in place saves a copy of every layer's cache per step) and returned.
* ``init_cache(batch_size, cache_len)`` — the zero cache.

The cache keeps the JAX layout: ``{"pos{j}": {leaf: [n_periods, B, ...]}}``
with ``k``/``v`` ``[.., B, Hkv, cache_len, Dh]`` for attention and
``tm_shift``/``cm_shift`` ``[.., B, D]`` and ``wkv`` ``[.., B, H, Dh, Dh]``
(f32) for RWKV, ``conv`` ``[.., B, K-1, Di]`` (compute dtype) and ``ssm``
``[.., B, Di, Ds]`` (f32) for Mamba.

Sharding (JAX's ``param_specs``, ``param_shardings``, ``cache_specs``,
``cache_shardings``): the specs are keyed like the port's ``state_dict``
(one tree a layer; ``models.convert.specs_to_jax`` stacks them into JAX's
``[n_periods, ...]`` leaves, whose first entry is ``None``).
``model.shard(mesh)`` places the parameters; under ``use_mesh`` the entry
points constrain their inputs (a plain tensor is the global value), the
activations at JAX's points, and return DTensors (``unshard`` gathers one);
the cache is made and kept placed by :meth:`cache_shardings`.
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.distributed.api import BATCH_AXES, TP_AXIS, constrain, local_op, stack

from .attention import kv_cache_spec
from .blocks import Block, block_defs, layer_pattern, run_stack_decode, run_stack_full
from .config import ArchConfig, torch_dtype
from .frontends import frontend_defs, project_frontend
from .layers import (ParamDef, ShardedDefs, add_params, cross_entropy_loss, embed_defs,
                     embed_lookup, norm_def, rms_norm, shapes_from_defs, shardings_from_defs,
                     specs_from_defs)

Cache = Dict[str, Dict[str, torch.Tensor]]
Batch = Union[Mapping[str, torch.Tensor], torch.Tensor]


class CausalLM(ShardedDefs, nn.Module):
    def __init__(self, cfg: ArchConfig, *, device: torch.device, seed: int = 0):
        super().__init__()
        self.cfg = cfg
        defs = {"embed": embed_defs(cfg), "final_norm": norm_def(cfg)}
        if cfg.frontend:
            defs["frontend"] = frontend_defs(cfg)
        add_params(self, defs, device=device, seed=seed)
        pattern, _ = layer_pattern(cfg)
        period = len(pattern)
        self.blocks = nn.ModuleList(
            Block(cfg, *pattern[layer % period], device=device, seed=seed,
                  prefix=f"/blocks/pos{layer % period}/{layer // period}")
            for layer in range(cfg.n_layers))

    @property
    def device(self) -> torch.device:
        return self.final_norm.device

    def param_defs(self) -> Dict[str, Any]:
        """The ParamDefs keyed like ``state_dict`` (one tree a layer)."""
        cfg = self.cfg
        pattern, _ = layer_pattern(cfg)
        defs: Dict[str, Any] = {"embed": embed_defs(cfg), "final_norm": norm_def(cfg)}
        if cfg.frontend:
            defs["frontend"] = frontend_defs(cfg)
        defs["blocks"] = {str(l): block_defs(cfg, *pattern[l % len(pattern)])
                          for l in range(cfg.n_layers)}
        return defs

    # ---- embedding / head --------------------------------------------------
    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        h = embed_lookup(self.embed["embedding"], tokens).to(torch_dtype(cfg.compute_dtype))
        if cfg.embed_scale:
            h = h * torch.tensor(cfg.d_model ** 0.5, dtype=h.dtype, device=h.device)
        return constrain(h, BATCH_AXES, None, None)

    def _logits(self, h: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        cdt = torch_dtype(cfg.compute_dtype)
        if cfg.tie_embeddings:
            logits = h @ self.embed["embedding"].to(cdt).T
        else:
            logits = h @ self.embed["lm_head"].to(cdt)
        if cfg.logit_softcap:
            c = cfg.logit_softcap
            logits = torch.tanh(logits / c) * c
        return constrain(logits, BATCH_AXES, None, TP_AXIS)

    def _positions(self, b: int, s: int, device) -> torch.Tensor:
        return constrain(torch.arange(s, device=device)[None].expand(b, s), BATCH_AXES, None)

    def _inputs(self, batch: Batch) -> Tuple[torch.Tensor, torch.Tensor]:
        """(token ids, embeddings with the frontend prefix fused in)."""
        if not isinstance(batch, Mapping):
            return batch, self._embed(batch)
        tokens = batch["tokens"]
        h = self._embed(tokens)
        if self.cfg.frontend and "frontend_feats" in batch:
            pre = project_frontend(self.frontend, batch["frontend_feats"], self.cfg)
            if pre.shape[1] > h.shape[1]:
                raise ValueError(f"{pre.shape[1]} frontend positions do not fit in "
                                 f"{h.shape[1]} tokens")
            h = torch.cat([pre.to(h.dtype), h[:, pre.shape[1]:]], dim=1)
        return tokens, h

    # ---- full-sequence path ------------------------------------------------
    def forward(self, batch: Batch) -> torch.Tensor:
        tokens, h = self._inputs(batch)
        b, s = tokens.shape
        positions = self._positions(b, s, tokens.device)
        h, _ = run_stack_full(self.blocks, h, positions, self.cfg, window=self.cfg.window)
        return self._logits(rms_norm(h, self.final_norm, self.cfg.norm_eps))

    def loss(self, batch: Mapping[str, torch.Tensor]
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        return cross_entropy_loss(self.forward(batch), batch["labels"],
                                  batch.get("loss_mask"))

    # ---- serving -----------------------------------------------------------
    def cache_defs(self, batch_size: int, cache_len: int) -> Dict[str, Any]:
        """ParamDef-style description of the decode cache (shapes + specs),
        JAX's: ``{"pos{j}": {leaf: [n_periods, B, ...]}}``."""
        cfg = self.cfg
        pattern, n_periods = layer_pattern(cfg)
        kv_spec = tuple(kv_cache_spec(cfg))
        cdt = cfg.compute_dtype
        out: Dict[str, Any] = {}
        for j, (kind, _) in enumerate(pattern):
            if kind == "attn":
                kv = ParamDef((batch_size, cfg.n_kv_heads, cache_len, cfg.hd), kv_spec, "zeros",
                              cdt)
                c = {"k": kv, "v": kv}
            elif kind == "mamba":
                c = {
                    "conv": ParamDef((batch_size, cfg.ssm_d_conv - 1, cfg.ssm_d_inner),
                                     (BATCH_AXES, None, TP_AXIS), "zeros", cdt),
                    "ssm": ParamDef((batch_size, cfg.ssm_d_inner, cfg.ssm_d_state),
                                    (BATCH_AXES, TP_AXIS, None), "zeros", "float32"),
                }
            else:  # rwkv
                shift = ParamDef((batch_size, cfg.d_model), (BATCH_AXES, None), "zeros", cdt)
                hd = cfg.rwkv_head_dim
                c = {
                    "tm_shift": shift,
                    "wkv": ParamDef((batch_size, cfg.rwkv_heads, hd, hd),
                                    (BATCH_AXES, TP_AXIS, None, None), "zeros", "float32"),
                    "cm_shift": shift,
                }
            out[f"pos{j}"] = {k: d.with_layer_dim(n_periods) for k, d in c.items()}
        return out

    def cache_specs(self, batch_size: int, cache_len: int) -> Dict[str, Any]:
        return specs_from_defs(self.cache_defs(batch_size, cache_len), fsdp=True)

    def cache_shardings(self, batch_size: int, cache_len: int, mesh) -> Dict[str, Any]:
        return shardings_from_defs(self.cache_defs(batch_size, cache_len), True, mesh)

    def cache_shapes(self, batch_size: int, cache_len: int) -> Dict[str, Any]:
        """The cache as meta tensors (:func:`shapes_from_defs`), JAX's layout."""
        return shapes_from_defs(self.cache_defs(batch_size, cache_len))

    def init_cache(self, batch_size: int, cache_len: int) -> Cache:
        """The zero cache (placed by its specs under a mesh)."""
        return {pos: {k: constrain(torch.zeros(d.shape, dtype=torch_dtype(d.dtype),
                                               device=self.device), *d.spec)
                      for k, d in leaves.items()}
                for pos, leaves in self.cache_defs(batch_size, cache_len).items()}

    def _stack_cache(self, per_layer: List[Dict[str, torch.Tensor]], b: int,
                     cache_len: int) -> Cache:
        """Per-layer prefill states → the stacked cache.  Attention k/v are
        padded with zeros to ``cache_len``, or cut to it when the prompt is
        longer."""
        defs = self.cache_defs(b, cache_len)
        period = len(defs)
        cache: Cache = {}
        def pad(v):      # k/v [B, Hkv, S, Dh] (S never sharded here) → cache_len slots
            return F.pad(v[:, :, :cache_len], (0, 0, 0, cache_len - min(v.shape[2], cache_len)))

        for j in range(period):
            leaves = {}
            for k, d in defs[f"pos{j}"].items():
                vals = [c[k] for c in per_layer[j::period]]
                if k in ("k", "v"):
                    vals = [local_op(pad, v) for v in vals]
                leaves[k] = constrain(stack(vals).to(torch_dtype(d.dtype)), *d.spec)
            cache[f"pos{j}"] = leaves
        return cache

    def prefill(self, batch: Batch, cache_len: int
                ) -> Tuple[torch.Tensor, Cache, torch.Tensor]:
        """Full forward + cache build.  Returns (last-token logits [B, 1, V],
        cache, lengths [B] int32)."""
        cfg = self.cfg
        tokens, h = self._inputs(batch)
        b, s = tokens.shape
        positions = self._positions(b, s, tokens.device)
        h, per_layer = run_stack_full(self.blocks, h, positions, cfg,
                                      window=cfg.window, collect_cache=True)
        h = rms_norm(h, self.final_norm, cfg.norm_eps)
        logits = self._logits(h[:, -1:])
        lengths = torch.full((b,), s, dtype=torch.int32, device=tokens.device)
        return logits, self._stack_cache(per_layer, b, cache_len), lengths

    def decode(self, cache: Cache, tokens: torch.Tensor, lengths: torch.Tensor
               ) -> Tuple[torch.Tensor, Cache, torch.Tensor]:
        """tokens [B, T_new] (typically T_new = 1).  Returns (logits, cache,
        lengths + T_new); ``cache`` is updated in place."""
        cfg = self.cfg
        h, cache = run_stack_decode(self.blocks, self._embed(tokens), cfg, cache, lengths,
                                    window=cfg.window)
        logits = self._logits(rms_norm(h, self.final_norm, cfg.norm_eps))
        return logits, cache, lengths + tokens.shape[1]
