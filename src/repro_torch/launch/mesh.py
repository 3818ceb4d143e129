"""Mesh construction (the port of ``repro.launch.mesh``).

Functions, not module constants: importing this module touches no process
group.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch.distributed as dist

from repro_torch.device import DeviceLike
from repro_torch.distributed.api import Mesh, make_mesh

__all__ = ["MeshLayout", "make_host_mesh", "make_production_mesh"]


@dataclasses.dataclass(frozen=True)
class MeshLayout:
    """A mesh's axes and sizes, with no world behind it.

    ``shape`` maps each axis name to its size in axis order (as
    ``jax.sharding.Mesh.shape``); ``size`` is the number of positions.
    """

    axis_names: Tuple[str, ...]
    shape: Dict[str, int]

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    @property
    def n_data(self) -> int:
        """Granule shards: the product of the ``pod`` and ``data`` axes."""
        return self.shape.get("pod", 1) * self.shape.get("data", 1)

    @property
    def n_model(self) -> int:
        """Candidate shards: the ``model`` axis."""
        return self.shape.get("model", 1)


def make_production_mesh(*, multi_pod: bool = False) -> MeshLayout:
    """Single pod: (data=16, model=16) = 256 positions.
    Multi-pod:  (pod=2, data=16, model=16) = 512 positions.

    Returns the layout only.  The port's :class:`~repro_torch.distributed.api.Mesh`
    is one rank of a started ``torch.distributed`` world, one process a
    position, and no one host starts 256 or 512 of them; the dry-run
    (``launch/dryrun.py``) models the production cell from this layout.
    """
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return MeshLayout(axis_names=axes, shape=dict(zip(axes, shape)))


def make_host_mesh(shape=None, axes=None, *, device: DeviceLike = "cuda") -> Mesh:
    """A small mesh over the started world's ranks (tests / local runs):
    by default one ``data`` axis over every rank."""
    if shape is None:
        shape, axes = (dist.get_world_size(),), ("data",)
    return make_mesh(shape, axes, device=device)
