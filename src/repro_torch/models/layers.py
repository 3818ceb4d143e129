"""Shared building blocks: parameter definitions, seeded init, norms, RoPE.

The port's ``repro.models.layers``.  Every module exposes a ``*_defs(cfg)``
function returning a dict of :class:`ParamDef` (shape, initializer, dtype)
— the single source of truth for the parameter tree.  :class:`ParamTree`
materializes such a dict as an ``nn.Module`` whose leaves are parameters on
the target device, so the model functions index it as the JAX package
indexes its nested dicts (``params["attn"]["wq"]``).

Init (``init_from_defs``'s twin): each leaf draws from its own
``torch.Generator`` on the target device, seeded from the model's seed and a
CRC-32 of the leaf's path.  The JAX package seeds from Python's salted
``hash(path)``, so its parameters differ between processes; the port's are
the same in every process, and the tests carry the JAX parameters across
with :func:`repro_torch.models.convert.params_from_jax` instead.  A leaf is
drawn in f32 on the device and cast there to its dtype: a full-width model
never exists as an f32 copy on the host.  Partition specs are not ported.

Parameters are created frozen (``requires_grad=False``): serving needs no
graph.  Training makes them trainable (``train.make_train_step``).
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from .config import torch_dtype

__all__ = ["ParamDef", "ParamTree", "add_params", "apply_rope", "cross_entropy_loss",
           "embed_defs", "init_param", "norm_def", "rms_norm", "rope_frequencies"]


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    init: str = "fan_in"             # fan_in | normal | zeros | ones
    dtype: str = "bfloat16"


def _leaf_seed(seed: int, path: str) -> int:
    return (seed * 1_000_003 + zlib.crc32(path.encode())) % (2 ** 63)


def init_param(d: ParamDef, path: str, seed: int, device: torch.device) -> torch.Tensor:
    """One leaf: zeros, ones, or N(0, 1) · (fan_in⁻¹ᐟ² or 0.02) in its dtype."""
    dtype = torch_dtype(d.dtype)
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=dtype, device=device)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=dtype, device=device)
    gen = torch.Generator(device=device).manual_seed(_leaf_seed(seed, path))
    scale = d.shape[-2] ** -0.5 if d.init == "fan_in" and len(d.shape) >= 2 else 0.02
    x = torch.randn(d.shape, generator=gen, dtype=torch.float32, device=device)
    return x.mul_(scale).to(dtype)


def add_params(module: nn.Module, defs: Dict[str, Any], *, device: torch.device,
               seed: int, prefix: str = "") -> None:
    """Register ``defs`` on ``module``: sub-dicts as :class:`ParamTree`
    children, leaves as (frozen) parameters."""
    for name, d in defs.items():
        path = f"{prefix}/{name}"
        if isinstance(d, dict):
            module.add_module(name, ParamTree(d, device=device, seed=seed, prefix=path))
        else:
            module.register_parameter(
                name, nn.Parameter(init_param(d, path, seed, device), requires_grad=False))


class ParamTree(nn.Module):
    """A nested dict of parameters as a module; ``tree["name"]`` reads a child."""

    def __init__(self, defs: Dict[str, Any], *, device: torch.device, seed: int,
                 prefix: str = ""):
        super().__init__()
        add_params(self, defs, device=device, seed=seed, prefix=prefix)

    def __getitem__(self, name: str):
        return getattr(self, name)


# ---------------------------------------------------------------------------
# numerics
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float) -> torch.Tensor:
    """RMS norm in f32, cast back to x's dtype *before* the gamma product."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * gamma.to(x.dtype)


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [B, H, S, Dh]; positions: [B, S] absolute token positions.

    The split-half layout (first half / second half of Dh), not interleaved
    pairs.
    """
    dh = x.shape[-1]
    freqs = rope_frequencies(dh, theta, device=x.device)                # [Dh/2]
    angles = positions[:, None, :, None].to(torch.float32) * freqs     # [B,1,S,Dh/2]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def cross_entropy_loss(
    logits: torch.Tensor,                  # [B, S, V]
    labels: torch.Tensor,                  # [B, S]
    mask: Optional[torch.Tensor] = None,   # [B, S], 1 where a token counts
    *,
    z_loss: float = 0.0,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean token NLL in f32 (logsumexp − gold logit, plus ``z_loss``·lse²)
    over the masked tokens; metrics ``loss``, ``accuracy`` (argmax = label)
    and ``tokens`` (the mask's sum, at least 1), detached."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    labels = labels.long()
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    nll = lse - gold
    if z_loss:
        nll = nll + z_loss * lse ** 2
    mask = torch.ones_like(nll) if mask is None else mask.float()
    denom = mask.sum().clamp_min(1.0)
    loss = (nll * mask).sum() / denom
    with torch.no_grad():
        acc = ((logits.argmax(-1) == labels) * mask).sum() / denom
    return loss, {"loss": loss.detach(), "accuracy": acc, "tokens": denom.detach()}


def embed_defs(cfg) -> Dict[str, ParamDef]:
    d = {"embedding": ParamDef((cfg.vocab, cfg.d_model), "normal", cfg.param_dtype)}
    if not cfg.tie_embeddings:
        d["lm_head"] = ParamDef((cfg.d_model, cfg.vocab), "fan_in", cfg.param_dtype)
    return d


def norm_def(cfg) -> ParamDef:
    return ParamDef((cfg.d_model,), "ones", cfg.param_dtype)
