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
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, Tuple, Union

import torch
from torch import nn

from .blocks import Block, layer_pattern, run_stack_decode, run_stack_full
from .config import ArchConfig, torch_dtype
from .frontends import frontend_defs, project_frontend
from .layers import add_params, cross_entropy_loss, embed_defs, norm_def, rms_norm

Cache = Dict[str, Dict[str, torch.Tensor]]
Batch = Union[Mapping[str, torch.Tensor], torch.Tensor]


class CausalLM(nn.Module):
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

    # ---- embedding / head --------------------------------------------------
    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        h = self.embed["embedding"][tokens.long()].to(torch_dtype(cfg.compute_dtype))
        if cfg.embed_scale:
            h = h * torch.tensor(cfg.d_model ** 0.5, dtype=h.dtype, device=h.device)
        return h

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
        return logits

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
        positions = torch.arange(s, device=tokens.device)[None].expand(b, s)
        h, _ = run_stack_full(self.blocks, h, positions, self.cfg, window=self.cfg.window)
        return self._logits(rms_norm(h, self.final_norm, self.cfg.norm_eps))

    def loss(self, batch: Mapping[str, torch.Tensor]
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        return cross_entropy_loss(self.forward(batch), batch["labels"],
                                  batch.get("loss_mask"))

    # ---- serving -----------------------------------------------------------
    def _cache_shapes(self, batch_size: int, cache_len: int) -> Dict[str, Dict[str, Any]]:
        cfg = self.cfg
        cdt = torch_dtype(cfg.compute_dtype)
        pattern, n_periods = layer_pattern(cfg)
        out = {}
        for j, (kind, _) in enumerate(pattern):
            if kind == "attn":
                kv = ((n_periods, batch_size, cfg.n_kv_heads, cache_len, cfg.hd), cdt)
                out[f"pos{j}"] = {"k": kv, "v": kv}
            elif kind == "mamba":
                out[f"pos{j}"] = {
                    "conv": ((n_periods, batch_size, cfg.ssm_d_conv - 1, cfg.ssm_d_inner), cdt),
                    "ssm": ((n_periods, batch_size, cfg.ssm_d_inner, cfg.ssm_d_state),
                            torch.float32),
                }
            else:  # rwkv
                shift = ((n_periods, batch_size, cfg.d_model), cdt)
                hd = cfg.rwkv_head_dim
                out[f"pos{j}"] = {
                    "tm_shift": shift,
                    "wkv": ((n_periods, batch_size, cfg.rwkv_heads, hd, hd), torch.float32),
                    "cm_shift": shift,
                }
        return out

    def init_cache(self, batch_size: int, cache_len: int) -> Cache:
        return {pos: {k: torch.zeros(shape, dtype=dt, device=self.device)
                      for k, (shape, dt) in leaves.items()}
                for pos, leaves in self._cache_shapes(batch_size, cache_len).items()}

    def _stack_cache(self, per_layer: List[Dict[str, torch.Tensor]], b: int,
                     cache_len: int) -> Cache:
        """Per-layer prefill states → the stacked cache.  Attention k/v are
        padded with zeros to ``cache_len``, or cut to it when the prompt is
        longer."""
        cache = self.init_cache(b, cache_len)
        period = len(cache)
        for layer, leaves in enumerate(per_layer):
            p, j = divmod(layer, period)
            for k, val in leaves.items():
                dst = cache[f"pos{j}"][k][p]
                if k in ("k", "v"):
                    n = min(val.shape[2], cache_len)
                    dst[:, :, :n] = val[:, :, :n]
                else:
                    dst.copy_(val)
        return cache

    def prefill(self, batch: Batch, cache_len: int
                ) -> Tuple[torch.Tensor, Cache, torch.Tensor]:
        """Full forward + cache build.  Returns (last-token logits [B, 1, V],
        cache, lengths [B] int32)."""
        cfg = self.cfg
        tokens, h = self._inputs(batch)
        b, s = tokens.shape
        positions = torch.arange(s, device=tokens.device)[None].expand(b, s)
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
