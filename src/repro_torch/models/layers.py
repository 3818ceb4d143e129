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
never exists as an f32 copy on the host.

Each ParamDef also carries the leaf's *logical* partition spec, as in JAX:
:func:`specs_from_defs` gives the spec tree (``fsdp=False`` strips the
``data`` axis unless ``keep_fsdp``) and :func:`shardings_from_defs` the
divisibility-filtered shardings on a mesh.  The values never depend on the
mesh: a sharded model is the seeded model with its leaves placed
(:func:`shard_params`).

Parameters are created frozen (``requires_grad=False``): serving needs no
graph.  Training makes them trainable (``train.make_train_step``).
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.distributed.api import (BATCH_AXES, FSDP_AXIS, TP_AXIS, P, active_mesh,
                                        axis_index, fit_entry, pmax, psum, replicate_like,
                                        shard_by_shape, shard_map)

from .config import torch_dtype

__all__ = ["ParamDef", "ParamTree", "add_params", "apply_rope", "cross_entropy_loss",
           "embed_defs", "init_param", "norm_def", "rms_norm", "rope_frequencies",
           "ShardedDefs", "embed_lookup", "flatten_tree", "shapes_from_defs", "shard_params",
           "shardings_from_defs",
           "specs_from_defs"]


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    spec: Tuple[Any, ...]            # logical partition entries, len == ndim
    init: str = "fan_in"             # fan_in | normal | zeros | ones
    dtype: str = "bfloat16"
    keep_fsdp: bool = False          # retain 'data' sharding even when fsdp=False
    # (serving: dense weights replicate over data, experts stay 2-D sharded)

    def with_layer_dim(self, n_layers: int) -> "ParamDef":
        return dataclasses.replace(self, shape=(n_layers, *self.shape), spec=(None, *self.spec))


def _map_defs(fn, defs: Dict[str, Any]) -> Dict[str, Any]:
    return {k: _map_defs(fn, d) if isinstance(d, dict) else fn(d) for k, d in defs.items()}


def specs_from_defs(defs: Dict[str, Any], fsdp: bool) -> Dict[str, Any]:
    """Spec tree of ``defs``.  fsdp=False strips the 'data' axis from specs."""
    def spec(d: ParamDef) -> P:
        entries = []
        for e in d.spec:
            if not fsdp and not d.keep_fsdp:
                if e == FSDP_AXIS:
                    e = None
                elif isinstance(e, tuple):
                    e = tuple(a for a in e if a != FSDP_AXIS) or None
            entries.append(e)
        return P(*entries)
    return _map_defs(spec, defs)


def shapes_from_defs(defs: Dict[str, Any]) -> Dict[str, Any]:
    """``defs`` with each leaf a ``meta`` tensor of its shape and dtype: the
    counterpart of JAX's ``ShapeDtypeStruct`` tree, allocating nothing."""
    return _map_defs(lambda d: torch.empty(d.shape, dtype=torch_dtype(d.dtype), device="meta"),
                     defs)


def shardings_from_defs(defs: Dict[str, Any], fsdp: bool, mesh) -> Dict[str, Any]:
    """Shardings of ``defs`` on ``mesh``, divisibility-filtered
    (:func:`repro_torch.distributed.api.shard_by_shape`)."""
    specs = specs_from_defs(defs, fsdp)

    def walk(sp, d):
        if isinstance(d, dict):
            return {k: walk(sp[k], d[k]) for k in d}
        return shard_by_shape(sp, d.shape, mesh)
    return walk(specs, defs)


def flatten_tree(tree: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    """A nested dict as ``{"a.b.c": leaf}`` (``state_dict`` keys)."""
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            out.update(flatten_tree(v, key))
        else:
            out[key] = v
    return out


def shard_params(model: nn.Module, shardings: Dict[str, Any]) -> nn.Module:
    """Place every parameter of ``model`` by ``shardings`` (``{state_dict
    key: NamedSharding}``, every key the model has): each becomes a DTensor
    parameter holding this rank's shard, as trainable as before."""
    missing = set(dict(model.named_parameters())) - set(shardings)
    if missing:
        raise KeyError(f"no sharding for {sorted(missing)[:4]}")
    for key, sh in shardings.items():
        *path, name = key.split(".")
        mod = model.get_submodule(".".join(path))
        p = getattr(mod, name)
        mod.register_parameter(name, nn.Parameter(sh.place(p.detach()),
                                                  requires_grad=p.requires_grad))
    return model


def _leaf_seed(seed: int, path: str) -> int:
    return (seed * 1_000_003 + zlib.crc32(path.encode())) % (2 ** 63)


def init_param(d: ParamDef, path: str, seed: int, device: torch.device) -> torch.Tensor:
    """One leaf: zeros, ones, or N(0, 1) · (fan_in⁻¹ᐟ² or 0.02) in its dtype;
    on the ``meta`` device (the dry-run's modelled card) uninitialised."""
    dtype = torch_dtype(d.dtype)
    if device.type == "meta":
        return torch.empty(d.shape, dtype=dtype, device=device)
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


class ShardedDefs:
    """The sharding methods of a model whose ``param_defs()`` is keyed like
    its ``state_dict`` (JAX's ``param_specs`` and ``param_shardings``, and
    the port's ``shard``)."""

    def param_specs(self) -> Dict[str, P]:
        """``{state_dict key: logical spec}``; ``cfg.fsdp`` False strips 'data'."""
        return flatten_tree(specs_from_defs(self.param_defs(), self.cfg.fsdp))

    def param_shardings(self, mesh) -> Dict[str, Any]:
        return flatten_tree(shardings_from_defs(self.param_defs(), self.cfg.fsdp, mesh))

    def param_shapes(self) -> Dict[str, torch.Tensor]:
        """``{state_dict key: meta tensor}`` (:func:`shapes_from_defs`)."""
        return flatten_tree(shapes_from_defs(self.param_defs()))

    def shard(self, mesh):
        """Place every parameter by :meth:`param_shardings` (DTensors on
        ``mesh.device_mesh``); returns the model."""
        return shard_params(self, self.param_shardings(mesh))


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
    freqs = replicate_like(rope_frequencies(dh, theta, device=x.device), x)   # [Dh/2]
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
    and ``tokens`` (the mask's sum, at least 1), detached.  Under a mesh,
    the vocab-parallel island :func:`_sharded_cross_entropy`."""
    mesh = active_mesh()
    if mesh is not None:
        return _sharded_cross_entropy(logits, labels, mask, z_loss, mesh)
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


def _sharded_cross_entropy(logits, labels, mask, z_loss: float, mesh):
    """:func:`cross_entropy_loss` as a :func:`shard_map` island: the logits
    stay sharded over the batch and (where it divides) the vocab, the max
    is a ``pmax`` over ``model``, the exp-sum and the gold logit are summed
    over it (``psum``), and the masked sums over the batch axes.  The argmax of the
    accuracy takes the lowest index among the ranks' maxima, as ``argmax``."""
    b, _, v = logits.shape
    bent, vent = fit_entry(BATCH_AXES, b, mesh), fit_entry(TP_AXIS, v, mesh)
    bax = () if bent is None else ((bent,) if isinstance(bent, str) else tuple(bent))
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32, device=labels.device)

    split = vent is not None and mesh.shape[TP_AXIS] > 1     # the vocab over >1 ranks

    def local(lg, lab, msk):
        lg, lab, msk = lg.float(), lab.long(), msk.float()
        if not split:               # the whole vocab here: the one-device formula
            lse = torch.logsumexp(lg, dim=-1)
            nll = lse - torch.gather(lg, -1, lab[..., None])[..., 0]
            if z_loss:
                nll = nll + z_loss * lse ** 2
            with torch.no_grad():
                hits = ((lg.argmax(-1) == lab) * msk).sum()
        else:
            v_loc = lg.shape[-1]
            v0 = axis_index(TP_AXIS) * v_loc
            m = pmax(lg.detach().amax(-1), TP_AXIS)
            se = psum(torch.exp(lg - m[..., None]).sum(-1), TP_AXIS)
            idx = lab - v0
            inside = (idx >= 0) & (idx < v_loc)
            gold = torch.gather(lg, -1, idx.clamp(0, v_loc - 1)[..., None])[..., 0] * inside
            lse = m + torch.log(se)
            nll = lse - psum(gold, TP_AXIS)
            if z_loss:
                nll = nll + z_loss * lse ** 2
            with torch.no_grad():
                best = lg.argmax(-1)
                val = torch.gather(lg, -1, best[..., None])[..., 0]
                pred = torch.where(val == pmax(val, TP_AXIS), best + v0, torch.full_like(best, v))
                pred = -pmax(-pred, TP_AXIS)          # the lowest index at the max
                hits = ((pred == lab) * msk).sum()
        num, den = (nll * msk).sum(), msk.sum()
        if bax:
            num, den, hits = psum(num, bax), psum(den, bax).detach(), psum(hits, bax)
        den = den.clamp_min(1.0)
        return num / den, hits / den, den

    batch2 = P(bent, None)
    loss, acc, den = shard_map(local, mesh=mesh, in_specs=(P(bent, None, vent), batch2, batch2),
                               out_specs=(P(), P(), P()))(logits, labels, mask)
    return loss, {"loss": loss.detach(), "accuracy": acc, "tokens": den}


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Rows of ``table`` [V, D] at ``tokens``.  Under a mesh a vocab-parallel
    island: each rank looks up the tokens in its vocab slice (zeros
    elsewhere) and one ``psum`` over ``model`` combines them, exactly (one
    rank's row plus zeros); DTensor's own rule for a vocab-sharded
    embedding does not hold on a batch-sharded 2-D mesh."""
    mesh = active_mesh()
    if mesh is None:
        return F.embedding(tokens.long(), table)
    bent = fit_entry(BATCH_AXES, tokens.shape[0], mesh)
    vent = fit_entry(TP_AXIS, table.shape[0], mesh)

    def local(tab, tok):
        v_loc = tab.shape[0]
        idx = tok.long() - (axis_index(TP_AXIS) * v_loc if vent else 0)
        inside = (idx >= 0) & (idx < v_loc)
        h = F.embedding(idx.clamp(0, v_loc - 1), tab) * inside[..., None].to(tab.dtype)
        return psum(h, TP_AXIS) if vent else h

    return shard_map(local, mesh=mesh, in_specs=(P(vent, None), P(bent, None)),
                     out_specs=P(bent, None, None))(table, tokens)


def embed_defs(cfg) -> Dict[str, ParamDef]:
    d = {"embedding": ParamDef((cfg.vocab, cfg.d_model), (TP_AXIS, FSDP_AXIS), "normal",
                               cfg.param_dtype)}
    if not cfg.tie_embeddings:
        d["lm_head"] = ParamDef((cfg.d_model, cfg.vocab), (FSDP_AXIS, TP_AXIS), "fan_in",
                                cfg.param_dtype)
    return d


def norm_def(cfg) -> ParamDef:
    return ParamDef((cfg.d_model,), (None,), "ones", cfg.param_dtype)
