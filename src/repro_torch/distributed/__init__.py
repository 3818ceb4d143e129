"""Distribution of the PLAR driver over ``torch.distributed`` ranks.

:mod:`.api` holds the mesh (:func:`make_mesh`), the rank start-up
(:func:`init_process_group`) and a local world launcher (:func:`spawn`).
The driver itself is :mod:`repro_torch.core.distributed`.
"""
from .api import DATA_AXES, MODEL_AXIS, Mesh, init_process_group, make_mesh, spawn

__all__ = ["DATA_AXES", "MODEL_AXIS", "Mesh", "init_process_group", "make_mesh", "spawn"]
