"""Mesh construction for local runs (the port of ``repro.launch.mesh``).

A function, not a module constant: importing this module touches no process
group.  ``make_production_mesh`` (the 256/512-chip topology) waits for the
LM distribution work of the roadmap.
"""
from __future__ import annotations

import torch.distributed as dist

from repro_torch.device import DeviceLike
from repro_torch.distributed.api import Mesh, make_mesh


def make_host_mesh(shape=None, axes=None, *, device: DeviceLike = "cuda") -> Mesh:
    """A small mesh over the started world's ranks (tests / local runs):
    by default one ``data`` axis over every rank."""
    if shape is None:
        shape, axes = (dist.get_world_size(),), ("data",)
    return make_mesh(shape, axes, device=device)
