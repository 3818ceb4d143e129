"""Contingency kernels: batched contingency, fused Θ and sweep Θ (CUDA, sm_90a).

``ops`` holds the wrappers (kernel on a CUDA tensor, plain version on a CPU
tensor, with launch counters), ``ref`` the plain PyTorch versions, ``build``
the ``nvcc`` build of ``csrc/``, ``model`` the kernels' cost model on the
card's figures and ``autotune`` the tile selector the wrappers resolve their
launch shape through.
"""
from .autotune import (
    SELECTOR_MODES,
    autotune_block_sizes,
    autotune_cache_clear,
    autotune_cache_info,
    resolve_tiles,
    select_block_sizes,
)
from .model import KernelCost, kernel_cost, modeled_time_s, rank_tiles
from .ops import (
    LAUNCHES,
    contingency,
    fused_theta,
    fused_theta_raw,
    launch_counts,
    reset_launch_counts,
    sweep_theta,
    theta_scale,
)
from .ref import contingency_ref, fused_theta_raw_ref, fused_theta_ref, sweep_theta_ref

__all__ = [
    "LAUNCHES",
    "contingency",
    "contingency_ref",
    "fused_theta",
    "fused_theta_raw",
    "fused_theta_raw_ref",
    "fused_theta_ref",
    "launch_counts",
    "reset_launch_counts",
    "sweep_theta",
    "sweep_theta_ref",
    "theta_scale",
    "select_block_sizes",
    "autotune_block_sizes",
    "autotune_cache_clear",
    "autotune_cache_info",
    "resolve_tiles",
    "SELECTOR_MODES",
    "KernelCost",
    "kernel_cost",
    "modeled_time_s",
    "rank_tiles",
]
