"""Meshes on ``torch.distributed``: one process a position.

The port of ``repro.distributed.api``.  JAX runs one controller over a
``jax.sharding.Mesh``; here every rank runs the same program on its own
shard (SPMD), and a :class:`Mesh` carries what a rank needs of the mesh: its
axis names and sizes, its coordinates, a ``DeviceMesh`` over the same
row-major rank layout (``Mesh.device_mesh``, for DTensor), and the PLAR
driver's two process groups: one for the data axes (``pod`` × ``data``,
flattened in that order: JAX's ``P(("pod", "data"))`` shard order) and one
for ``model``.

* :func:`init_process_group` starts a rank: NCCL on the card, gloo on the
  CPU; from ``RANK``/``WORLD_SIZE`` when ``torchrun`` set them, else from an
  explicit rank, world size and a ``FileStore`` path.
* :func:`make_mesh` lays the world's ranks out row-major over the mesh shape
  (``jax.make_mesh``'s device order) and builds the groups.  Every rank
  creates every group, in one order, or the run hangs.
* :func:`spawn` runs a function on a fresh world of local ranks and fails,
  instead of hanging, when a rank fails or the world outlives its deadline.

The sharding half (LM distribution).  Model code names no concrete mesh: it
calls :func:`constrain` with a *logical* spec at fixed points, and the mesh
set by :func:`use_mesh` decides.  Axes the mesh does not have are dropped
(:func:`resolve_spec`), and so are axes whose size does not divide the
dimension (:func:`shard_by_shape`: 40 RWKV heads on a 16-way ``model`` axis
are replicated).  Without a mesh :func:`constrain` returns its input; with
one it returns a DTensor with the spec's placements (a ``redistribute``; a
plain tensor counts as the global value, the same on every rank).  JAX maps
tensor dims to mesh axes and DTensor mesh dims to tensor dims, so the spec
is inverted (:func:`placements`); one tensor dim sharded over
``("pod", "data")`` is ``Shard(d)`` on both mesh dims, pod-major.

:func:`shard_map` is JAX's explicit SPMD island over ``to_local`` /
``from_local``: the function sees each rank's local shards, and
:func:`psum`, :func:`pmax`, :func:`all_gather` and :func:`axis_index` act
on the axis groups of ``Mesh.device_mesh``.  Its
gradients follow JAX's transpose of ``shard_map``: an input replicated over
a mesh axis gets the sum of the ranks' cotangents (``Partial``), an output
replicated over one hands each rank the cotangent over the axis size, and
``psum`` transposes to ``psum``.

PyTorch APIs used (present from torch 2.5 on): ``DeviceMesh(device_type,
mesh, mesh_dim_names=)``, ``DeviceMesh.get_group``,
``torch.distributed.tensor`` (``DTensor.from_local``, ``to_local(
grad_placements=)``, ``redistribute``, ``full_tensor``, ``Shard``,
``Replicate``, ``Partial``), ``torch.distributed.all_reduce`` /
``all_gather`` / ``batch_isend_irecv`` / ``get_global_rank``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import math
import multiprocessing
import os
import shutil
import tempfile
import time
from contextvars import ContextVar
from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.device import DeviceLike, resolve_device

__all__ = ["Mesh", "make_mesh", "init_process_group", "spawn", "DATA_AXES", "MODEL_AXIS",
           "BATCH_AXES", "FSDP_AXIS", "TP_AXIS", "P", "NamedSharding", "active_mesh",
           "use_mesh", "resolve_spec", "placements", "sharding_for", "shard_by_shape", "fit_entry",
           "constrain", "place_like", "replicate_like", "local_op", "grad_in_placements",
           "stack", "batch_spec", "axis_size", "mesh_batch_shards", "shard_map",
           "axis_index", "psum", "pmax", "all_gather", "unshard"]

# The PLAR mesh's axes: granules shard over the data axes, candidates over
# 'model' (DESIGN.md §2).
DATA_AXES: Tuple[str, ...] = ("pod", "data")
MODEL_AXIS = "model"
PIPE_AXIS = "pipe"
_AXES = ("pod", PIPE_AXIS, "data", MODEL_AXIS)

# The LM's logical axes (DESIGN.md §3.3):
#   batch  → ('pod', 'data')   data parallelism (pods are pure DP)
#   fsdp   → 'data'            ZeRO parameter/optimizer sharding
#   tp     → 'model'           tensor parallelism (heads / d_ff / vocab / experts)
BATCH_AXES: Tuple[str, ...] = ("pod", "data")
FSDP_AXIS = "data"
TP_AXIS = "model"


@dataclasses.dataclass(eq=False)
class Mesh:
    """This rank's view of a mesh over ``pod``, ``pipe``, ``data``, ``model``.

    ``shape`` maps each axis name to its size, in axis order (as
    ``jax.sharding.Mesh.shape``); ``coords`` gives this rank's position and
    ``device_mesh`` is the ``DeviceMesh`` over the same layout (dim names =
    axis names).  For the PLAR driver: ``data_axes`` are the mesh's data
    axes (``pod``, ``data``) and ``n_data`` the number of data shards (their
    sizes' product), ``n_model`` the number of model shards.
    ``data_index`` is this rank's shard over the data axes (pod-major) and
    ``model_index`` its candidate slice; ``data_group`` joins the ranks that
    share this rank's model index (and pipe index), ``model_group`` those
    that share its data index (``None`` without a model axis).  Hashed by
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
    device_mesh: DeviceMesh


def make_mesh(shape: Sequence[int], axis_names: Sequence[str], *,
              device: DeviceLike = "cuda") -> Mesh:
    """The counterpart of ``repro.distributed.api.make_mesh``: lay the
    world's ranks over ``shape`` and build this rank's process groups and
    its ``DeviceMesh``.

    Needs a started process group (:func:`init_process_group`) whose world
    size is the product of ``shape``.  ``device`` is this rank's device: on
    ``cuda`` the current CUDA device, which :func:`init_process_group` set.
    """
    shape = tuple(int(s) for s in shape)
    axis_names = tuple(str(a) for a in axis_names)
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} and axis names {axis_names} differ in length")
    unknown = [a for a in axis_names if a not in _AXES]
    if unknown or len(set(axis_names)) != len(axis_names):
        raise ValueError(f"mesh axes must be distinct names among "
                         f"{', '.join(_AXES)}; got {axis_names}")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a started process group (init_process_group)")
    world, rank = dist.get_world_size(), dist.get_rank()
    if int(np.prod(shape)) != world:
        raise ValueError(f"mesh {dict(zip(axis_names, shape))} needs {int(np.prod(shape))} "
                         f"ranks; the world has {world}")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())

    # rank grid [n_pipe, n_data, n_model]: pipe first, the data axes
    # (pod-major), 'model' last
    grid = np.arange(world).reshape(shape)
    data_axes = tuple(a for a in DATA_AXES if a in axis_names)
    p_pos = [axis_names.index(PIPE_AXIS)] if PIPE_AXIS in axis_names else []
    d_pos = [axis_names.index(a) for a in data_axes]
    m_pos = [axis_names.index(MODEL_AXIS)] if MODEL_AXIS in axis_names else []
    n_model = shape[m_pos[0]] if m_pos else 1
    n_pipe = shape[p_pos[0]] if p_pos else 1
    grid = grid.transpose(p_pos + d_pos + m_pos).reshape(n_pipe, -1, n_model)

    # every rank creates every group, data groups first, in one order
    data_group = model_group = None
    for p in range(n_pipe):
        for m in range(n_model):
            g = dist.new_group([int(r) for r in grid[p, :, m]])
            if rank in grid[p, :, m]:
                data_group = g
    if m_pos:
        for p in range(n_pipe):
            for s in range(grid.shape[1]):
                g = dist.new_group([int(r) for r in grid[p, s]])
                if rank in grid[p, s]:
                    model_group = g
    _, data_index, model_index = (int(v[0]) for v in np.nonzero(grid == rank))
    coords = {a: int(c) for a, c in zip(axis_names, np.unravel_index(rank, shape))}
    # the dry-run's modelled card (``meta`` tensors) keeps a CUDA DeviceMesh:
    # DTensor's sharding propagation asks the mesh's device type for its handle
    device_mesh = DeviceMesh("cuda" if dev.type == "meta" else dev.type,
                             torch.arange(world).reshape(shape), mesh_dim_names=axis_names)
    return Mesh(axis_names=axis_names, shape=dict(zip(axis_names, shape)), device=dev,
                rank=rank, coords=coords, data_axes=data_axes, n_data=grid.shape[1],
                n_model=n_model, data_index=data_index, model_index=model_index,
                data_group=data_group, model_group=model_group, device_mesh=device_mesh)


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


# ---------------------------------------------------------------------------
# the sharding half: logical specs, placements, constrain
# ---------------------------------------------------------------------------

_ACTIVE_MESH: ContextVar[Optional[Mesh]] = ContextVar("repro_torch_active_mesh", default=None)
_ISLAND_MESH: ContextVar[Optional[Mesh]] = ContextVar("repro_torch_island_mesh", default=None)


class P(tuple):
    """A logical partition spec, ``jax.sharding.PartitionSpec``'s
    counterpart: one entry a tensor dim, each ``None``, an axis name or a
    tuple of axis names (major first; a one-name tuple is kept as the name,
    as JAX canonicalizes it).  A tuple, so it compares equal to JAX's spec
    with the same entries."""

    def __new__(cls, *entries):
        return super().__new__(cls, (e[0] if isinstance(e, tuple) and len(e) == 1 else e
                                     for e in entries))

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


Spec = Union[P, Sequence]


def active_mesh() -> Optional[Mesh]:
    return _ACTIVE_MESH.get()


@contextlib.contextmanager
def use_mesh(mesh: Optional[Mesh]):
    token = _ACTIVE_MESH.set(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE_MESH.reset(token)


def _filter_spec(spec: Sequence, mesh) -> P:
    """Drop mesh axes the mesh doesn't have (e.g. 'pod' on one pod)."""
    names = set(mesh.axis_names)
    out = []
    for entry in spec:
        if entry is None:
            out.append(None)
        elif isinstance(entry, str):
            out.append(entry if entry in names else None)
        else:  # tuple of axis names
            kept = tuple(a for a in entry if a in names)
            out.append(kept if kept else None)
    return P(*out)


def resolve_spec(spec: Spec, mesh=None) -> Optional[P]:
    mesh = mesh or active_mesh()
    if mesh is None:
        return None
    return _filter_spec(tuple(spec), mesh)


def _divisible(entry, dim: int, mesh):
    """Drop spec entries whose mesh-axis product does not divide the dim."""
    if entry is None:
        return None
    axes = (entry,) if isinstance(entry, str) else tuple(entry)
    kept = []
    prod = 1
    for a in axes:
        size = mesh.shape[a]
        if dim % (prod * size) == 0:
            kept.append(a)
            prod *= size
    if not kept:
        return None
    return kept[0] if len(kept) == 1 else tuple(kept)


def placements(spec: Spec, axis_names: Sequence[str]) -> Tuple:
    """The DTensor placements (one a mesh dim) of a resolved spec: mesh dim
    ``i`` is ``Shard(d)`` where tensor dim ``d``'s entry names axis ``i``,
    else ``Replicate()``.  DTensor splits a dim sharded over several mesh
    dims in mesh order, so such an entry must name its axes in that order."""
    axis_names = tuple(axis_names)
    out = [Replicate()] * len(axis_names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        pos = [axis_names.index(a) for a in axes]
        if pos != sorted(pos):
            raise ValueError(f"spec entry {entry} names its axes against the mesh order "
                             f"{axis_names}")
        for i in pos:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"axis {axis_names[i]} shards two dims of spec {tuple(spec)}")
            out[i] = Shard(d)
    return tuple(out)


@dataclasses.dataclass(frozen=True, eq=False)
class NamedSharding:
    """A resolved spec on a mesh (``jax.sharding.NamedSharding``'s
    counterpart); ``placements`` are its DTensor placements on
    ``mesh.device_mesh``."""

    mesh: Any
    spec: P

    @property
    def placements(self) -> Tuple:
        return placements(self.spec, self.mesh.axis_names)

    def place(self, x: torch.Tensor) -> DTensor:
        """``x`` as a DTensor with these placements.  A DTensor is
        redistributed; a plain tensor is the global value, the same on every
        rank, and each rank keeps its shard of it (no communication)."""
        return _place(x, self.mesh.device_mesh, self.placements)

    def shard_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        """This rank's local shape of a global ``shape`` (JAX's
        ``NamedSharding.shard_shape``; an uneven split gives rank 0's, the
        larger, as DTensor does)."""
        out = list(shape)
        for d, entry in enumerate(self.spec):
            for a in () if entry is None else _axes(entry):
                out[d] = -(-out[d] // self.mesh.shape[a])
        return tuple(out)


def _place(x: torch.Tensor, dm: DeviceMesh, pl: Sequence) -> DTensor:
    if (not isinstance(x, DTensor) and x.device.type == "meta"
            and any(isinstance(p, Shard) for p in pl)):
        # the dry-run's modelled card: a meta value has no data to split, so
        # the rank's shard is made at its own size (not a view of the global)
        local = list(x.shape)
        for p, n in zip(pl, dm.shape):
            if isinstance(p, Shard):
                local[p.dim] = -(-local[p.dim] // n)
        return DTensor.from_local(torch.empty(local, dtype=x.dtype, device=x.device), dm, pl,
                                  run_check=False, shape=x.shape, stride=x.stride())
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, dm, [Replicate()] * dm.ndim, run_check=False)
    if tuple(x.placements) == tuple(pl):
        return x
    return x.redistribute(dm, pl)


def sharding_for(spec: Spec, mesh=None) -> Optional[NamedSharding]:
    mesh = mesh or active_mesh()
    if mesh is None:
        return None
    return NamedSharding(mesh, _filter_spec(tuple(spec), mesh))


def shard_by_shape(spec: Spec, shape: Tuple[int, ...], mesh=None) -> Optional[NamedSharding]:
    """Divisibility-aware sharding: axes that don't divide are dropped
    (replication is always legal)."""
    mesh = mesh or active_mesh()
    if mesh is None:
        return None
    filtered = tuple(_filter_spec(tuple(spec), mesh))
    entries = [_divisible(e, d, mesh) for e, d in zip(filtered, shape)]
    return NamedSharding(mesh, P(*entries))


def fit_entry(entry, dim: int, mesh=None):
    """One spec entry as :func:`shard_by_shape` resolves it for a dim of
    size ``dim``: absent axes and axes that don't divide dropped."""
    mesh = mesh or active_mesh()
    return _divisible(_filter_spec((entry,), mesh)[0], dim, mesh)


def constrain(x: torch.Tensor, *spec) -> torch.Tensor:
    """``x`` placed by the logical ``spec`` on the active mesh: a DTensor
    (redistributed where its placements differ), or ``x`` itself without a
    mesh.  Divisibility-aware, as :func:`shard_by_shape`."""
    mesh = active_mesh()
    if mesh is None:
        return x
    return shard_by_shape(P(*spec), x.shape, mesh).place(x)


def place_like(x: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """``x`` with ``ref``'s placements when ``ref`` is a DTensor (a plain
    ``x`` counts as the global value), else ``x``."""
    return _place(x, ref.device_mesh, ref.placements) if isinstance(ref, DTensor) else x


def replicate_like(x: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """A plain ``x`` (the same on every rank) as a replicated DTensor on
    ``ref``'s mesh when ``ref`` is a DTensor, else ``x``: for constants
    made inside model code that meet sharded activations."""
    if not isinstance(ref, DTensor) or isinstance(x, DTensor):
        return x
    return DTensor.from_local(x, ref.device_mesh, [Replicate()] * ref.device_mesh.ndim,
                              run_check=False)


def local_op(fn, x: torch.Tensor, *, shift: int = 0) -> torch.Tensor:
    """``fn`` applied to each rank's shard of ``x`` (a DTensor; a plain
    tensor as it is), the result keeping ``x``'s placements with every
    sharded dim moved by ``shift``.  Exact where ``fn`` leaves the sharded
    dims alone (a pad or cut of an unsharded dim, a new leading dim): for
    ops whose DTensor rule is missing or wrong in some torch versions."""
    if not isinstance(x, DTensor):
        return fn(x)
    pl = [Shard(p.dim + shift) if isinstance(p, Shard) else p for p in x.placements]
    return DTensor.from_local(fn(x.to_local()), x.device_mesh, pl, run_check=False)


def grad_in_placements(x: torch.Tensor) -> torch.Tensor:
    """``x`` itself, whose gradient is redistributed to ``x``'s placements on
    the way back (a DTensor; a plain tensor is returned as it is).  DTensor
    hands an op the gradient in the placements of whatever consumed its
    output; a view that splits a dim into heads cannot take it sharded where
    the heads do not divide the mesh axis."""
    if not isinstance(x, DTensor):
        return x
    return DTensor.from_local(x.to_local(), x.device_mesh, x.placements, run_check=False,
                              shape=x.shape, stride=x.stride())


def stack(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """``torch.stack`` along a new leading dim; DTensors shard by shard
    (each placed like the first), with :func:`local_op`."""
    ref = xs[0]
    if not isinstance(ref, DTensor):
        return torch.stack(xs)
    return local_op(lambda t: torch.stack([t] + [place_like(x, ref).to_local()
                                                 for x in xs[1:]]), ref, shift=1)


def batch_spec(*trailing) -> P:
    """P(('pod','data'), *trailing) — the activation batch sharding."""
    return P(BATCH_AXES, *trailing)


def axis_size(name: str, mesh=None) -> int:
    mesh = mesh or active_mesh() or _ISLAND_MESH.get()
    if mesh is None or name not in mesh.axis_names:
        return 1
    return mesh.shape[name]


def mesh_batch_shards(mesh=None) -> int:
    return axis_size("pod", mesh) * axis_size("data", mesh)


def unshard(x):
    """The global value of ``x``: a DTensor gathered (``full_tensor``, a
    collective every rank must call), anything else as it is."""
    return x.full_tensor() if isinstance(x, DTensor) else x


# ---------------------------------------------------------------------------
# explicit SPMD islands
# ---------------------------------------------------------------------------


def _tree_map(fn, spec, *trees):
    """``fn(leaf_spec, *leaves)`` over a spec tree (dicts, lists and tuples
    of :class:`P`; ``None`` for a leaf that is not sharded)."""
    if spec is None or isinstance(spec, P):
        return fn(spec, *trees)
    if isinstance(spec, dict):
        return {k: _tree_map(fn, spec[k], *(t[k] for t in trees)) for k in spec}
    return type(spec)(_tree_map(fn, s, *(t[i] for t in trees)) for i, s in enumerate(spec))


class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, factor):
        ctx.factor = factor
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.factor, None


def _enter(spec, x, mesh):
    if spec is None or not isinstance(x, torch.Tensor):
        return x
    pl = placements(_filter_spec(spec, mesh), mesh.axis_names)
    d = NamedSharding(mesh, _filter_spec(spec, mesh)).place(x)
    # a replicated input's cotangent is the sum over the ranks (JAX's transpose)
    return d.to_local(grad_placements=[Partial() if isinstance(p, Replicate) else p
                                       for p in pl])


def _leave(spec, y, mesh):
    if spec is None or not isinstance(y, torch.Tensor):
        return y
    pl = placements(_filter_spec(spec, mesh), mesh.axis_names)
    rep = math.prod(n for p, n in zip(pl, mesh.device_mesh.shape) if isinstance(p, Replicate))
    if rep > 1 and y.requires_grad:
        y = _ScaleGrad.apply(y, 1.0 / rep)
    return DTensor.from_local(y, mesh.device_mesh, pl, run_check=False)


def shard_map(f: Callable, *, mesh: Mesh, in_specs, out_specs, check_vma: bool = False
              ) -> Callable:
    """JAX's ``shard_map``: ``f`` runs on every rank on its local shards.

    ``in_specs`` has one spec tree a positional argument (``None`` for an
    argument that is not a tensor), ``out_specs`` one for the result.  An
    argument is placed by its spec first (a plain tensor counts as the
    global value); the result comes back as DTensors with the out specs'
    placements.  Inside ``f`` the collectives of this module act on
    ``mesh``, and :func:`constrain` is a no-op.  ``check_vma`` is accepted
    for JAX's signature and ignored."""
    del check_vma

    def run(*args):
        local = _tree_map(lambda s, a: _enter(s, a, mesh), tuple(in_specs), args)
        island = _ISLAND_MESH.set(mesh)
        active = _ACTIVE_MESH.set(None)
        try:
            out = f(*local)
        finally:
            _ACTIVE_MESH.reset(active)
            _ISLAND_MESH.reset(island)
        return _tree_map(lambda s, y: _leave(s, y, mesh), out_specs, out)

    return run


def _collective_mesh() -> Mesh:
    mesh = _ISLAND_MESH.get() or active_mesh()
    if mesh is None:
        raise RuntimeError("a collective needs a mesh: call it inside shard_map or use_mesh")
    return mesh


def _axes(names) -> Tuple[str, ...]:
    return (names,) if isinstance(names, str) else tuple(names)


def axis_index(name: str) -> int:
    """This rank's coordinate on axis ``name`` (``jax.lax.axis_index``)."""
    return _collective_mesh().coords[name]


def _all_reduce(x: torch.Tensor, names, op, mesh: Optional[Mesh] = None) -> torch.Tensor:
    mesh = mesh or _collective_mesh()
    out = x.contiguous().clone()
    for a in _axes(names):
        if mesh.shape[a] > 1:
            dist.all_reduce(out, op=op, group=mesh.device_mesh.get_group(a))
    return out


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, names):
        ctx.names, ctx.mesh = names, _collective_mesh()
        return _all_reduce(x, names, dist.ReduceOp.SUM, ctx.mesh)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.names, dist.ReduceOp.SUM, ctx.mesh), None


def psum(x: torch.Tensor, names) -> torch.Tensor:
    """Sum over the ranks of the named axes (``jax.lax.psum``); its
    transpose is itself."""
    return _Psum.apply(x, _axes(names))


def pmax(x: torch.Tensor, names) -> torch.Tensor:
    """Maximum over the ranks of the named axes (``jax.lax.pmax``), no
    gradient."""
    return _all_reduce(x.detach(), _axes(names), dist.ReduceOp.MAX)


def _flat_index(names, mesh: Mesh) -> int:
    idx = 0
    for a in names:
        idx = idx * mesh.shape[a] + mesh.coords[a]
    return idx


def _gather(x: torch.Tensor, names, axis: int, mesh: Mesh) -> torch.Tensor:
    for a in reversed(names):                   # innermost axis first: major-first order
        n = mesh.shape[a]
        if n > 1:
            parts = [torch.empty_like(x) for _ in range(n)]
            dist.all_gather(parts, x.contiguous(), group=mesh.device_mesh.get_group(a))
            x = torch.cat(parts, dim=axis)
    return x


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, names, axis):
        ctx.names, ctx.axis, ctx.n, ctx.mesh = names, axis, x.shape[axis], _collective_mesh()
        return _gather(x, names, axis, ctx.mesh)

    @staticmethod
    def backward(ctx, g):                       # JAX: psum_scatter
        g = _all_reduce(g, ctx.names, dist.ReduceOp.SUM, ctx.mesh)
        idx = _flat_index(ctx.names, ctx.mesh)
        return g.narrow(ctx.axis, idx * ctx.n, ctx.n), None, None


def all_gather(x: torch.Tensor, names, *, axis: int = 0, tiled: bool = True) -> torch.Tensor:
    """Concatenation along ``axis`` of every rank's ``x`` over the named
    axes, major axis first (``jax.lax.all_gather(..., tiled=True)``)."""
    if not tiled:
        raise ValueError("all_gather is tiled only")
    return _AllGather.apply(x, _axes(names), axis)


def _shift(x: torch.Tensor, name: str, pairs, mesh: Mesh) -> torch.Tensor:
    """``jax.lax.ppermute`` without autograd: rank ``src`` of axis ``name``
    sends ``x`` to ``dst`` for each pair (a ``batch_isend_irecv``); a rank
    no pair sends to gets zeros."""
    me = mesh.coords[name]
    out = torch.zeros_like(x)
    if mesh.shape[name] == 1:
        return x.clone() if (0, 0) in pairs else out
    group = mesh.device_mesh.get_group(name)
    ops = []
    for src, dst in pairs:
        if src == me:
            ops.append(dist.P2POp(dist.isend, x.contiguous(), dist.get_global_rank(group, dst),
                                  group))
        if dst == me:
            ops.append(dist.P2POp(dist.irecv, out, dist.get_global_rank(group, src), group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out
