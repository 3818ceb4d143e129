"""The mesh of the PLAR driver on ``torch.distributed``: one process a position.

The port of the mesh part of ``repro.distributed.api``.  JAX runs the mesh
driver from one controller over a ``jax.sharding.Mesh``; here every rank runs
the same driver on its own shard (SPMD), and a :class:`Mesh` carries what a
rank needs of the mesh: its axis names and sizes, its coordinates, and one
process group for the data axes (``pod`` × ``data``, flattened in that order:
JAX's ``P(("pod", "data"))`` shard order) and one for ``model``.

* :func:`init_process_group` starts a rank: NCCL on the card, gloo on the
  CPU; from ``RANK``/``WORLD_SIZE`` when ``torchrun`` set them, else from an
  explicit rank, world size and a ``FileStore`` path.
* :func:`make_mesh` lays the world's ranks out row-major over the mesh shape
  (``jax.make_mesh``'s device order) and builds the groups.  Every rank
  creates every group, in one order, or the run hangs.
* :func:`spawn` runs a function on a fresh world of local ranks and fails,
  instead of hanging, when a rank fails or the world outlives its deadline.

The logical-axis helpers of the JAX module (``constrain``, ``use_mesh``, the
partition specs) belong to LM distribution and are not ported here.
"""
from __future__ import annotations

import dataclasses
import datetime
import multiprocessing
import os
import shutil
import tempfile
import time
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.device import DeviceLike, resolve_device

__all__ = ["Mesh", "make_mesh", "init_process_group", "spawn", "DATA_AXES", "MODEL_AXIS"]

# The PLAR mesh's axes: granules shard over the data axes, candidates over
# 'model' (DESIGN.md §2).
DATA_AXES: Tuple[str, ...] = ("pod", "data")
MODEL_AXIS = "model"


@dataclasses.dataclass(eq=False)
class Mesh:
    """This rank's view of a ``('pod',) 'data', 'model'`` mesh.

    ``shape`` maps each axis name to its size, in axis order (as
    ``jax.sharding.Mesh.shape``); ``coords`` gives this rank's position.
    ``data_axes`` are the mesh's data axes (``pod``, ``data``) and ``n_data``
    the number of data shards (their sizes' product), ``n_model`` the number
    of model shards.  ``data_index`` is this rank's shard over the data axes
    (pod-major) and ``model_index`` its candidate slice; ``data_group`` joins
    the ranks that share this rank's model index, ``model_group`` those that
    share its data index (``None`` without a model axis).  Hashed by
    identity: a runner cached on a mesh is that mesh's.
    """

    axis_names: Tuple[str, ...]
    shape: Dict[str, int]
    device: torch.device
    rank: int
    coords: Dict[str, int]
    data_axes: Tuple[str, ...]
    n_data: int
    n_model: int
    data_index: int
    model_index: int
    data_group: object
    model_group: Optional[object]


def make_mesh(shape: Sequence[int], axis_names: Sequence[str], *,
              device: DeviceLike = "cuda") -> Mesh:
    """The counterpart of ``repro.distributed.api.make_mesh``: lay the
    world's ranks over ``shape`` and build this rank's process groups.

    Needs a started process group (:func:`init_process_group`) whose world
    size is the product of ``shape``.  ``device`` is this rank's device: on
    ``cuda`` the current CUDA device, which :func:`init_process_group` set.
    """
    shape = tuple(int(s) for s in shape)
    axis_names = tuple(str(a) for a in axis_names)
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} and axis names {axis_names} differ in length")
    unknown = [a for a in axis_names if a not in DATA_AXES + (MODEL_AXIS,)]
    if unknown or len(set(axis_names)) != len(axis_names):
        raise ValueError(f"mesh axes must be distinct names among "
                         f"{', '.join(DATA_AXES + (MODEL_AXIS,))}; got {axis_names}")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a started process group (init_process_group)")
    world, rank = dist.get_world_size(), dist.get_rank()
    if int(np.prod(shape)) != world:
        raise ValueError(f"mesh {dict(zip(axis_names, shape))} needs {int(np.prod(shape))} "
                         f"ranks; the world has {world}")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())

    # rank grid with the data axes first (pod-major) and 'model' last
    grid = np.arange(world).reshape(shape)
    data_axes = tuple(a for a in DATA_AXES if a in axis_names)
    d_pos = [axis_names.index(a) for a in data_axes]
    m_pos = [axis_names.index(MODEL_AXIS)] if MODEL_AXIS in axis_names else []
    n_model = shape[m_pos[0]] if m_pos else 1
    grid = grid.transpose(d_pos + m_pos).reshape(-1, n_model)    # [n_data, n_model]

    # every rank creates every group, data groups first, in one order
    data_group = model_group = None
    for m in range(n_model):
        g = dist.new_group([int(r) for r in grid[:, m]])
        if rank in grid[:, m]:
            data_group = g
    if m_pos:
        for s in range(grid.shape[0]):
            g = dist.new_group([int(r) for r in grid[s]])
            if rank in grid[s]:
                model_group = g
    data_index, model_index = (int(v[0]) for v in np.nonzero(grid == rank))
    coords = {a: int(c) for a, c in zip(axis_names, np.unravel_index(rank, shape))}
    return Mesh(axis_names=axis_names, shape=dict(zip(axis_names, shape)), device=dev,
                rank=rank, coords=coords, data_axes=data_axes, n_data=grid.shape[0],
                n_model=n_model, data_index=data_index, model_index=model_index,
                data_group=data_group, model_group=model_group)


def init_process_group(device: DeviceLike = "cuda", *, rank: Optional[int] = None,
                       world_size: Optional[int] = None, store_path: Optional[str] = None,
                       timeout_s: float = 300.0) -> torch.device:
    """Start this process's rank and return its device.

    NCCL for ``cuda`` (the rank takes the card ``LOCAL_RANK``, else its rank
    on this host), gloo for ``cpu``.  Under ``torchrun`` (``RANK`` and
    ``WORLD_SIZE`` in the environment, no ``rank`` passed) the rendezvous is
    the environment's; otherwise ``rank``, ``world_size`` and ``store_path`` (a file every rank
    can reach, absent or empty before the first rank starts) are required.
    ``timeout_s`` bounds the rendezvous and every collective.
    """
    dev = resolve_device(device)
    timeout = datetime.timedelta(seconds=timeout_s)
    from_env = rank is None and "RANK" in os.environ and "WORLD_SIZE" in os.environ
    if from_env:
        rank, world_size = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    elif rank is None or world_size is None or store_path is None:
        raise ValueError("pass rank=, world_size= and store_path= (or run under torchrun)")
    kw = {}
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank))
        if local >= torch.cuda.device_count():
            raise RuntimeError(f"rank {rank} needs card {local}; {torch.cuda.device_count()} "
                               "visible (NCCL puts one rank on one card)")
        torch.cuda.set_device(local)
        dev = torch.device("cuda", local)
        kw["device_id"] = dev
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if from_env:
        dist.init_process_group(backend, init_method="env://", timeout=timeout, **kw)
    else:
        dist.init_process_group(backend, store=dist.FileStore(store_path, world_size),
                                rank=rank, world_size=world_size, timeout=timeout, **kw)
    return dev


def _rank_main(target: Callable, rank: int, world_size: int, device: str, store_path: str,
               timeout_s: float, args: tuple) -> None:
    if torch.device(device).type == "cpu":
        torch.set_num_threads(1)     # one core a rank: ranks share the host's cores
    dev = init_process_group(device, rank=rank, world_size=world_size, store_path=store_path,
                             timeout_s=timeout_s)
    try:
        target(dev, *args)
    finally:
        dist.destroy_process_group()


def spawn(target: Callable, world_size: int, args: tuple = (), *, device: DeviceLike = "cuda",
          timeout_s: float = 600.0) -> None:
    """Run ``target(device, *args)`` on ``world_size`` fresh local ranks.

    Each rank is a ``spawn``-started process with its process group up
    (:func:`init_process_group`, a ``FileStore`` in a fresh temporary
    directory) and torn down after ``target``; ``target`` and ``args`` must
    pickle (a module-level function).  Raises when a rank exits non-zero or
    the world is still running after ``timeout_s``; either way every rank
    is stopped before it returns.  On ``cuda`` the world may not exceed the
    visible cards.
    """
    dev = resolve_device(device)
    if dev.type == "cuda" and world_size > torch.cuda.device_count():
        raise RuntimeError(f"{world_size} ranks need {world_size} GPUs; "
                           f"{torch.cuda.device_count()} visible (NCCL puts one rank on one card)")
    ctx = multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="repro_torch_world_")
    store = os.path.join(tmp, "store")
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(target, r, world_size, dev.type, store, timeout_s, args))
             for r in range(world_size)]
    deadline = time.monotonic() + timeout_s
    try:
        for p in procs:
            p.start()
        while any(p.is_alive() for p in procs):
            bad = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
            if bad:
                raise RuntimeError(f"rank {bad[0][0]} exited with code {bad[0][1]}")
            if time.monotonic() > deadline:
                raise TimeoutError(f"a world of {world_size} ranks ran past {timeout_s} s")
            time.sleep(0.02)
        bad = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode != 0]
        if bad:
            raise RuntimeError(f"rank {bad[0][0]} exited with code {bad[0][1]}")
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(5)
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(tmp, ignore_errors=True)
