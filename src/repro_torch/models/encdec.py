"""Encoder–decoder model (the seamless-m4t family, audio frontend stubbed).

The port of ``repro.models.encdec``.  Encoder: bidirectional self-attention
(the flash kernel with ``causal=False``) over projected frame embeddings.
Decoder: causal self-attention, then cross-attention over the encoder
memory.  Serving decomposes as in JAX:

* ``prefill(batch, cache_len)`` — encode ``batch["frames"]``, project every
  decoder layer's cross K/V once, and start an empty self-attention cache;
  returns (cache, lengths), no logits.
* ``decode(cache, tokens, lengths)`` — decoder tokens against the cache;
  the self-attention K/V are written in place at each sequence's length.

The JAX package stacks each stack's layers ``[n_layers, ...]`` and scans;
the port keeps one parameter tree per layer (``encoder.{l}``,
``decoder.{l}``).  The cache keeps JAX's layout: ``k``, ``v`` ``[dec_layers,
B, Hkv, cache_len, Dh]`` and ``cross_k``, ``cross_v`` ``[dec_layers, B, Hkv,
enc_len, Dh]``, in the compute dtype.  Sharding as :class:`CausalLM`'s: the
specs keyed like the ``state_dict``, the activations constrained at JAX's
points, the cache placed by :meth:`cache_shardings` under a mesh.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.api import BATCH_AXES, TP_AXIS, constrain, stack

from .attention import (attn_defs, cross_attention, kv_cache_spec, project_cross_kv,
                        self_attention_decode, self_attention_full)
from .blocks import remat_fn
from .config import ArchConfig, torch_dtype
from .frontends import frontend_defs, project_frontend
from .layers import (ParamDef, ParamTree, ShardedDefs, add_params, cross_entropy_loss,
                     embed_defs, embed_lookup, norm_def, rms_norm, shapes_from_defs,
                     shardings_from_defs, specs_from_defs)
from .mlp import mlp, mlp_defs

Cache = Dict[str, torch.Tensor]


def _enc_block_defs(cfg) -> Dict[str, Any]:
    return {"norm1": norm_def(cfg), "attn": attn_defs(cfg),
            "norm2": norm_def(cfg), "ffn": mlp_defs(cfg)}


def _dec_block_defs(cfg) -> Dict[str, Any]:
    return {"norm1": norm_def(cfg), "self_attn": attn_defs(cfg),
            "norm2": norm_def(cfg), "cross_attn": attn_defs(cfg),
            "norm3": norm_def(cfg), "ffn": mlp_defs(cfg)}


class EncDecLM(ShardedDefs, nn.Module):
    def __init__(self, cfg: ArchConfig, *, device: torch.device, seed: int = 0):
        super().__init__()
        self.cfg = cfg
        add_params(self, {"embed": embed_defs(cfg), "frontend": frontend_defs(cfg),
                          "enc_norm": norm_def(cfg), "final_norm": norm_def(cfg)},
                   device=device, seed=seed)
        self.encoder = nn.ModuleList(
            ParamTree(_enc_block_defs(cfg), device=device, seed=seed, prefix=f"/encoder/{l}")
            for l in range(cfg.enc_layers))
        self.decoder = nn.ModuleList(
            ParamTree(_dec_block_defs(cfg), device=device, seed=seed, prefix=f"/decoder/{l}")
            for l in range(cfg.dec_layers))

    @property
    def device(self) -> torch.device:
        return self.final_norm.device

    def param_defs(self) -> Dict[str, Any]:
        """The ParamDefs keyed like ``state_dict`` (one tree a layer)."""
        cfg = self.cfg
        return {"embed": embed_defs(cfg), "frontend": frontend_defs(cfg),
                "enc_norm": norm_def(cfg), "final_norm": norm_def(cfg),
                "encoder": {str(l): _enc_block_defs(cfg) for l in range(cfg.enc_layers)},
                "decoder": {str(l): _dec_block_defs(cfg) for l in range(cfg.dec_layers)}}

    def _positions(self, b: int, s: int, device) -> torch.Tensor:
        return constrain(torch.arange(s, device=device)[None].expand(b, s), BATCH_AXES, None)

    def _stack(self, layers, body, h):
        """``body(layer, h)`` over ``layers``; with ``cfg.remat`` and grad
        enabled each layer recomputes in the backward (JAX checkpoints its
        scan body)."""
        for layer in layers:
            if self.cfg.remat and torch.is_grad_enabled():
                h = checkpoint(remat_fn(body), layer, h, use_reentrant=False)
            else:
                h = body(layer, h)
        return h

    # ---- encoder ------------------------------------------------------------
    def encode(self, frames: torch.Tensor) -> torch.Tensor:
        """frames [B, Se, frontend_dim] → memory [B, Se, D]."""
        cfg = self.cfg
        h = project_frontend(self.frontend, frames, cfg)
        b, s, _ = h.shape
        positions = self._positions(b, s, h.device)

        def body(layer, h):
            x = rms_norm(h, layer["norm1"], cfg.norm_eps)
            h = h + self_attention_full(layer["attn"], x, positions, cfg, causal=False)
            x = rms_norm(h, layer["norm2"], cfg.norm_eps)
            return h + mlp(layer["ffn"], x, cfg)

        return rms_norm(self._stack(self.encoder, body, h), self.enc_norm, cfg.norm_eps)

    # ---- decoder ------------------------------------------------------------
    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        h = embed_lookup(self.embed["embedding"], tokens)
        return constrain(h.to(torch_dtype(self.cfg.compute_dtype)), BATCH_AXES, None, None)

    def _decode_stack_full(self, tokens: torch.Tensor, memory: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        h = self._embed(tokens)
        b, s = tokens.shape
        positions = self._positions(b, s, tokens.device)

        def body(layer, h):
            x = rms_norm(h, layer["norm1"], cfg.norm_eps)
            h = h + self_attention_full(layer["self_attn"], x, positions, cfg)
            x = rms_norm(h, layer["norm2"], cfg.norm_eps)
            mk, mv = project_cross_kv(layer["cross_attn"], memory, cfg)
            h = h + cross_attention(layer["cross_attn"], x, mk, mv, cfg)
            x = rms_norm(h, layer["norm3"], cfg.norm_eps)
            return h + mlp(layer["ffn"], x, cfg)

        return rms_norm(self._stack(self.decoder, body, h), self.final_norm, cfg.norm_eps)

    def _logits(self, h: torch.Tensor) -> torch.Tensor:
        logits = h @ self.embed["lm_head"].to(torch_dtype(self.cfg.compute_dtype))
        return constrain(logits, BATCH_AXES, None, TP_AXIS)

    # ---- teacher forcing / training -------------------------------------------
    def forward(self, batch: Mapping[str, torch.Tensor]) -> torch.Tensor:
        """Teacher-forced logits [B, S, V] of ``batch["tokens"]`` over the
        encoded ``batch["frames"]``."""
        return self._logits(self._decode_stack_full(batch["tokens"],
                                                    self.encode(batch["frames"])))

    def loss(self, batch: Mapping[str, torch.Tensor]
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        return cross_entropy_loss(self.forward(batch), batch["labels"],
                                  batch.get("loss_mask"))

    # ---- serving --------------------------------------------------------------
    def cache_defs(self, batch_size: int, cache_len: int, enc_len: int) -> Dict[str, Any]:
        cfg = self.cfg
        kv_spec = tuple(kv_cache_spec(cfg))

        def kv(s_):
            return ParamDef((batch_size, cfg.n_kv_heads, s_, cfg.hd), kv_spec, "zeros",
                            cfg.compute_dtype).with_layer_dim(cfg.dec_layers)
        return {"k": kv(cache_len), "v": kv(cache_len),
                "cross_k": kv(enc_len), "cross_v": kv(enc_len)}

    def cache_specs(self, batch_size: int, cache_len: int, enc_len: int) -> Dict[str, Any]:
        return specs_from_defs(self.cache_defs(batch_size, cache_len, enc_len), fsdp=True)

    def cache_shardings(self, batch_size: int, cache_len: int, enc_len: int, mesh):
        return shardings_from_defs(self.cache_defs(batch_size, cache_len, enc_len), True, mesh)

    def cache_shapes(self, batch_size: int, cache_len: int, enc_len: int) -> Dict[str, Any]:
        """The cache as meta tensors (:func:`shapes_from_defs`), JAX's layout."""
        return shapes_from_defs(self.cache_defs(batch_size, cache_len, enc_len))

    def init_cache(self, batch_size: int, cache_len: int, enc_len: int) -> Cache:
        """The zero cache (placed by its specs under a mesh)."""
        return {k: constrain(torch.zeros(d.shape, dtype=torch_dtype(d.dtype),
                                         device=self.device), *d.spec)
                for k, d in self.cache_defs(batch_size, cache_len, enc_len).items()}

    def prefill(self, batch: Mapping[str, torch.Tensor], cache_len: int
                ) -> Tuple[Cache, torch.Tensor]:
        """Encode the frames, project every decoder layer's cross K/V, and
        start an empty self cache.  Returns (cache, lengths [B] int32 zeros)."""
        cdt = torch_dtype(self.cfg.compute_dtype)
        memory = self.encode(batch["frames"])
        b = memory.shape[0]
        kvs = [project_cross_kv(layer["cross_attn"], memory, self.cfg) for layer in self.decoder]
        cache = self.init_cache(b, cache_len, 0)
        spec = self.cache_defs(b, cache_len, memory.shape[1])["cross_k"].spec
        cache["cross_k"] = constrain(stack([k for k, _ in kvs]).to(cdt), *spec)
        cache["cross_v"] = constrain(stack([v for _, v in kvs]).to(cdt), *spec)
        return cache, torch.zeros((b,), dtype=torch.int32, device=memory.device)

    def decode(self, cache: Cache, tokens: torch.Tensor, lengths: torch.Tensor
               ) -> Tuple[torch.Tensor, Cache, torch.Tensor]:
        """tokens [B, T_new].  Returns (logits [B, T_new, V], cache, lengths +
        T_new); the self-attention K/V are written into ``cache`` in place."""
        cfg = self.cfg
        h = self._embed(tokens)
        for l, layer in enumerate(self.decoder):
            x = rms_norm(h, layer["norm1"], cfg.norm_eps)
            o, _, _ = self_attention_decode(layer["self_attn"], x, cfg, cache["k"][l],
                                            cache["v"][l], lengths)
            h = h + o
            x = rms_norm(h, layer["norm2"], cfg.norm_eps)
            h = h + cross_attention(layer["cross_attn"], x, cache["cross_k"][l],
                                    cache["cross_v"][l], cfg)
            x = rms_norm(h, layer["norm3"], cfg.norm_eps)
            h = h + mlp(layer["ffn"], x, cfg)
        logits = self._logits(rms_norm(h, self.final_norm, cfg.norm_eps))
        return logits, cache, lengths + tokens.shape[1]
