"""Setups of every dry-run cell: the port of ``repro.launch.specs``.

JAX builds ``ShapeDtypeStruct`` stand-ins and shardings and lowers a jitted
step against them.  The port runs its own step eagerly, so each builder
returns the step and its arguments placed on ``mesh`` (one rank's view of
it):

    (fn, args: tuple, placements: tuple, donate: tuple[int])

``fn(*args)`` is one step of the port: ``train.make_train_step`` over the
model (its AdamW moments in :func:`moment_dtype_for`), ``model.prefill`` or
``model.decode`` under ``use_mesh(mesh)`` (serving under ``no_grad``).
``args`` mirror JAX's argument trees, each leaf a DTensor placed by the
matching leaf of ``placements`` (``NamedSharding``\\s: the model's
``param_shardings`` and ``cache_shardings``, the batch rule of
:func:`_batch_sharding`).  The parameters are the model's own (the port's
step updates them in place, where JAX donates the state: ``donate`` keeps
JAX's ``(0,)`` / ``()`` / ``(1,)``).

Inside :func:`repro_torch.device.modelling` the model is built on the
``meta`` device (uninitialised, no memory) and every argument is a meta
shard of its local shape: what the dry-run counts.  Outside it the same
builders make real tensors on the mesh's device (the batch and the cache
zero-filled, the parameters seeded), so one step can be run and counted on
the card as well.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from repro_torch.distributed.api import BATCH_AXES, P, sharding_for, use_mesh
from repro_torch.models import build_model
from repro_torch.models.config import SHAPES, ArchConfig, ShapeConfig
from repro_torch.train import AdamW, constant_schedule, make_train_step

__all__ = ["BIG_PARAM_THRESHOLD", "make_decode_setup", "make_prefill_setup", "make_setup",
           "make_train_setup", "moment_dtype_for", "n_periods_of", "probe_config"]

BIG_PARAM_THRESHOLD = 50e9      # ≥: bf16 optimizer moments (HBM budget)


def _sds(shape, dtype) -> torch.Tensor:
    """A global shape and dtype as a meta tensor (JAX's ``ShapeDtypeStruct``)."""
    return torch.empty(shape, dtype=getattr(torch, dtype), device="meta")


def _placed(shapes, shardings, mesh):
    """A tree of meta tensors as zeros on the mesh's device, each placed by
    its sharding (a meta shard of its local shape inside ``modelling``)."""
    if isinstance(shapes, dict):
        return {k: _placed(shapes[k], shardings[k], mesh) for k in shapes}
    return shardings.place(torch.zeros(shapes.shape, dtype=shapes.dtype, device=mesh.device))


def _batch_sharding(mesh, batch_size: int, extra_dims: int):
    """Batch sharded over (pod, data) when divisible, else replicated."""
    n = 1
    for a in BATCH_AXES:
        if a in mesh.axis_names:
            n *= mesh.shape[a]
    spec = P(BATCH_AXES, *([None] * extra_dims)) if batch_size % n == 0 \
        else P(*([None] * (extra_dims + 1)))
    return sharding_for(spec, mesh)


def _train_batch(cfg: ArchConfig, shape: ShapeConfig, mesh):
    """(the batch's shapes, its shardings), JAX's keys."""
    b, s = shape.global_batch, shape.seq_len
    shapes: Dict[str, Any] = {}
    shard: Dict[str, Any] = {}
    if cfg.is_encdec:
        dec = s // 4
        shapes["frames"] = _sds((b, s, cfg.frontend_dim), "float32")
        shapes["tokens"] = _sds((b, dec), "int32")
        shapes["labels"] = _sds((b, dec), "int32")
        shard["frames"] = _batch_sharding(mesh, b, 2)
        shard["tokens"] = shard["labels"] = _batch_sharding(mesh, b, 1)
        return shapes, shard
    shapes["tokens"] = _sds((b, s), "int32")
    shapes["labels"] = _sds((b, s), "int32")
    shard["tokens"] = shard["labels"] = _batch_sharding(mesh, b, 1)
    if cfg.frontend == "vision":
        shapes["frontend_feats"] = _sds((b, cfg.frontend_tokens, cfg.frontend_dim), "float32")
        shard["frontend_feats"] = _batch_sharding(mesh, b, 2)
    return shapes, shard


def moment_dtype_for(cfg: ArchConfig) -> str:
    return "bfloat16" if cfg.param_count() >= BIG_PARAM_THRESHOLD else "float32"


def _placed_model(cfg: ArchConfig, mesh):
    """The model on the mesh's device, its parameters placed on ``mesh``."""
    model = build_model(cfg, device=mesh.device)
    return model.shard(mesh), model.param_shardings(mesh)


def make_train_setup(cfg: ArchConfig, shape: ShapeConfig, mesh, *, microbatches: int = 1):
    model, psh = _placed_model(cfg, mesh)
    opt = AdamW(lr=constant_schedule(3e-4), moment_dtype=moment_dtype_for(cfg))
    fn = make_train_step(model, opt, microbatches=microbatches, mesh=mesh)
    params = dict(model.named_parameters())
    moments = opt.init(params)              # zeros in the parameters' placements
    state = {"params": params, "opt_m": moments.m, "opt_v": moments.v,
             "opt_step": moments.step}
    state_sh = {"params": psh, "opt_m": psh, "opt_v": psh, "opt_step": sharding_for(P(), mesh)}
    batch_shapes, batch_sh = _train_batch(cfg, shape, mesh)
    return fn, (state, _placed(batch_shapes, batch_sh, mesh)), (state_sh, batch_sh), (0,)


def make_prefill_setup(cfg: ArchConfig, shape: ShapeConfig, mesh):
    model, psh = _placed_model(cfg, mesh)
    b, s = shape.global_batch, shape.seq_len
    if cfg.is_encdec:
        batch_shapes = {"frames": _sds((b, s, cfg.frontend_dim), "float32")}
        batch_sh = {"frames": _batch_sharding(mesh, b, 2)}
        cache_len = 1024
    else:
        batch_shapes = {"tokens": _sds((b, s), "int32")}
        batch_sh = {"tokens": _batch_sharding(mesh, b, 1)}
        if cfg.frontend == "vision":
            batch_shapes["frontend_feats"] = _sds((b, cfg.frontend_tokens, cfg.frontend_dim),
                                                  "float32")
            batch_sh["frontend_feats"] = _batch_sharding(mesh, b, 2)
        cache_len = s

    def fn(params, batch):
        with use_mesh(mesh), torch.no_grad():
            return model.prefill(batch, cache_len=cache_len)

    return (fn, (dict(model.named_parameters()), _placed(batch_shapes, batch_sh, mesh)),
            (psh, batch_sh), ())


def _attn_cache_len(cfg: ArchConfig, shape: ShapeConfig) -> int:
    s = shape.seq_len
    if cfg.window and s > cfg.window:
        return cfg.window            # rolling-window cache (jamba long_500k)
    return s


def make_decode_setup(cfg: ArchConfig, shape: ShapeConfig, mesh):
    model, psh = _placed_model(cfg, mesh)
    b = shape.global_batch
    with use_mesh(mesh):                 # the cache's spec reads the mesh, as in JAX
        if cfg.is_encdec:
            cache_shapes = model.cache_shapes(b, 1024, shape.seq_len)
            cache_sh = model.cache_shardings(b, 1024, shape.seq_len, mesh)
        else:
            clen = _attn_cache_len(cfg, shape)
            cache_shapes = model.cache_shapes(b, clen)
            cache_sh = model.cache_shardings(b, clen, mesh)
    tok_sh = _batch_sharding(mesh, b, 1)
    len_sh = _batch_sharding(mesh, b, 0)

    def fn(params, cache, tokens, lengths):
        with use_mesh(mesh), torch.no_grad():
            return model.decode(cache, tokens, lengths)

    args = (dict(model.named_parameters()), _placed(cache_shapes, cache_sh, mesh),
            _placed(_sds((b, 1), "int32"), tok_sh, mesh),
            _placed(_sds((b,), "int32"), len_sh, mesh))
    return fn, args, (psh, cache_sh, tok_sh, len_sh), (1,)


def make_setup(cfg: ArchConfig, shape_name: str, mesh, **kw):
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    if shape.kind == "train":
        return make_train_setup(cfg, shape, mesh, **kw)
    if shape.kind == "prefill":
        return make_prefill_setup(cfg, shape, mesh)
    return make_decode_setup(cfg, shape, mesh)


def probe_config(cfg: ArchConfig, n_periods: int) -> ArchConfig:
    """Unrolled shallow clone for the cost-extrapolation probes."""
    from repro_torch.models.blocks import layer_pattern
    if cfg.is_encdec:
        return dataclasses.replace(
            cfg, enc_layers=n_periods, dec_layers=n_periods,
            n_layers=n_periods, scan_unroll=True, remat=False, attn_naive=True,
        )
    period = len(layer_pattern(cfg)[0])
    return dataclasses.replace(
        cfg, n_layers=period * n_periods, scan_unroll=True, remat=False,
        attn_naive=True,
    )


def n_periods_of(cfg: ArchConfig) -> int:
    from repro_torch.models.blocks import layer_pattern
    if cfg.is_encdec:
        return cfg.enc_layers  # enc+dec scale together in probe_config
    return layer_pattern(cfg)[1]
