"""Distribution over ``torch.distributed`` ranks.

:mod:`.api` holds the mesh (:func:`make_mesh`, with its ``DeviceMesh``),
the rank start-up (:func:`init_process_group`), a local world launcher
(:func:`spawn`) and the LM's sharding half: logical specs, :func:`constrain`
over DTensor, :func:`shard_map` islands and their collectives.
:mod:`.compression` is the int8 compressed all-reduce with error feedback,
:mod:`.pipeline_parallel` GPipe over a ``pipe`` axis.  The PLAR driver
itself is :mod:`repro_torch.core.distributed`.
"""
from .api import (
    BATCH_AXES, DATA_AXES, FSDP_AXIS, MODEL_AXIS, TP_AXIS, Mesh, NamedSharding, P,
    active_mesh, all_gather, axis_index, axis_size, batch_spec, constrain,
    init_process_group, make_mesh, mesh_batch_shards, placements, pmax, psum,
    resolve_spec, shard_by_shape, shard_map, sharding_for, spawn, unshard, use_mesh,
)
from .compression import (
    compressed_grad_mean, compressed_psum_mean, dequantize_int8,
    init_error_state, quantize_int8,
)
from .pipeline_parallel import pipeline_apply, pipeline_loss

__all__ = [
    "BATCH_AXES", "FSDP_AXIS", "TP_AXIS",
    "active_mesh", "axis_size", "batch_spec", "constrain", "make_mesh",
    "mesh_batch_shards", "resolve_spec", "shard_map", "sharding_for", "use_mesh",
    "compressed_grad_mean", "compressed_psum_mean", "dequantize_int8",
    "init_error_state", "quantize_int8",
    "pipeline_apply", "pipeline_loss",
    # the port's own
    "DATA_AXES", "MODEL_AXIS", "Mesh", "NamedSharding", "P", "all_gather", "axis_index",
    "init_process_group", "placements", "pmax", "psum", "shard_by_shape",
    "spawn", "unshard",
]
