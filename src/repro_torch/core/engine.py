"""Device-resident greedy selection engine, the PyTorch port of ``repro.core.engine``.

The paper's PLAR loop is "cache once, iterate on device".  The host loop of
:func:`repro_torch.core.reduction.plar_reduce` reads Θ values back every
iteration, argmins them in numpy and dispatches each op of the next
iteration from Python.  This module keeps the whole reduction on the device:

* :class:`SelectionState` — the tensors the loop mutates: class ids
  ``r_ids``, spark fingerprints ``h1``/``h2``, the FSPA shrink mask
  ``active`` + PR correction, the ``remaining`` mask, the ``[A]``-slot
  Θ history and selection order, the class count ``k``.
* one greedy body — evaluate **all** candidates, masked argmin-with-ties,
  fold the winner (presence-bitmap compaction), update history and shrink
  state.  Every shape is static: packed ids stay below ``cap · v_max``, so
  one body serves every iteration.  Core attributes and warm-start
  prefixes are *forced* picks of the same body.
* the loop — JAX's ``lax.while_loop`` becomes a body whose every state
  field is ``torch.where(live, updated, old)``, with ``live`` the loop
  condition evaluated on the device, so a body run after the stop is an
  exact no-op.  On a CUDA device the body is captured once per runner as a
  CUDA graph and replayed; the host reads nothing back inside the loop but
  a ``done`` flag, copied without blocking into pinned memory after every
  :data:`POLL_PERIOD` bodies, and stops replaying once it reads it set.  On
  the CPU the same body runs eagerly, with the same gating and polling.
* :func:`init_state_from_reduct` / :func:`engine_resume` — the warm-start
  seam of the online service: seeding folds a prefix with the greedy phase
  disabled (``theta_full = +inf``), resuming continues greedy from there.
* one runner (:class:`_Runner`, one cached factory) — a grid of configs
  (measure, tolerances, feature cap, shrink, forced prefix, bagged weights)
  over one granularity in one gated body; each config freezes once its own
  condition is false, so its trajectory is its solo run's.  A solo run is a
  grid of one config, the mesh's a grid of one over the mesh adapter.

Every candidate chunk is evaluated by one function, :func:`_eval_chunk`
(the host loop's too), and on a mesh by :func:`_mesh_thetas` (the mesh host
loop's too): what each backend takes is read from ``plan.BACKENDS``.

``engine="auto"`` runs the plain backends (:data:`DEVICE_BACKENDS`) here, as
the JAX engine runs only its XLA ones.  Asked for by name
(``engine="device"``), the body also launches the CUDA kernels
(:data:`KERNEL_BACKENDS`); on the card ``segment`` launches the fused Θ
kernel (``plan.card_kernel``).  A kernel's launch shape is resolved once a
runner (:func:`body_tiles`, outside the capture) and is part of the
runner's key: a tuning persisted after a capture makes a new runner,
captured anew, never a replay of the old tiles.  The dispatch spans count
the kernel launches the replayed bodies held (``theta_launches``).
``ladder=True`` is accepted and every body evaluates at the top rung
``cap · v_max``: the sweep epilogue is bit-identical at every rung ≥ K·V
(DESIGN.md §5.3), and the recorded Θ history comes from the advance, which
keeps the full bound on every path.  A device-side rung choice (JAX's
``lax.switch`` on ``st.k``) has no counterpart in a CUDA graph.

Collectives go through a small adapter, the one seam between the drivers:
:class:`_LocalColl` is the identity; :class:`_MeshColl` sums contingencies
over the data shards of a mesh and gathers per-model-shard Θ values, with
``torch.distributed`` on one rank a mesh position, and
:func:`make_engine_run_mesh` runs the same gated body over it
(:mod:`repro_torch.core.distributed`).  The ``fused`` collective schedule
stays on the mesh's host loop, as in JAX: its class regrouping moves
granules between ranks between iterations.
"""
from __future__ import annotations

import dataclasses
import gc
import time
from functools import lru_cache, partial
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import obs
from repro_torch.device import to_host

from . import measures
from .guard import device_guard
from .granularity import (
    column_terms,
    dyn_column_terms,
    ids_from_presence,
    presence_bitmap,
)
from .plan import (
    BACKENDS,
    DEVICE_BACKENDS,
    ENSEMBLE_BACKENDS,
    KERNEL_BACKENDS,
    candidate_contingency,
    candidate_theta,
    card_kernel,
    check_stacked,
    contingency_from_ids,
    ids_by_sort,
    sweep_contingency,
)

__all__ = [
    "SelectionState",
    "init_state",
    "init_state_from_reduct",
    "engine_resume",
    "make_engine_step",
    "make_engine_run",
    "runner_for",
    "run_engine",
    "unpack_result",
    "DEVICE_BACKENDS",
    "KERNEL_BACKENDS",
    "body_tiles",
    "POLL_PERIOD",
    "EnsembleOperands",
    "init_ensemble_state",
    "make_ensemble_run",
    "run_ensemble",
    "unpack_ensemble_result",
    "ENSEMBLE_DELTAS",
    "ENSEMBLE_BACKENDS",
    "release_graphs",
    "make_engine_run_mesh",
    "merge_candidate_cont",
]

# Measures of the stacked engine; each config's measure is static.
ENSEMBLE_DELTAS = tuple(measures.RAW_ROWS)  # ("PR", "SCE", "LCE", "CCE")

# Bodies replayed between two reads of the ``done`` flag.  The read of a
# group's flag waits only for the group before it, so the card always has a
# group queued and a run replays P to 2P − 1 no-op bodies past its stop.
# Each no-op body costs a whole body: on the H100 at kdd99 (segment/PR, a
# body ~18 ms) the loop read 0.180 s at P = 1 against 0.216 / 0.288 /
# 0.432 s at P = 2 / 4 / 8, and mushroom (2,000 rows) was no faster at any
# P above 1 (``python -m repro_torch.launch.time_engine``; PERF.md §6).
POLL_PERIOD = 1

_MASK32 = 0xFFFFFFFF


class _Tensors:
    """A dataclass of tensors, read in field order."""

    def tensors(self) -> Tuple[torch.Tensor, ...]:
        return tuple(getattr(self, f.name) for f in dataclasses.fields(self))

    def clone(self):
        return type(self)(*(t.clone() for t in self.tensors()))

    def copy_(self, other) -> None:
        for dst, src in zip(self.tensors(), other.tensors()):
            dst.copy_(src)


@dataclasses.dataclass
class SelectionState(_Tensors):
    """Everything the greedy loop mutates, as tensors on one device.

    Shapes (``cap`` = granule capacity, ``A`` = number of attributes); the
    stacked ensemble adds a leading ``[C]`` axis to every field:

      r_ids          [cap] int32   dense class ids of U/R (K ≤ cap)
      h1, h2         [cap] int64   linear-sketch fingerprints of R's columns,
                                   uint32 values (spark mode; zeros otherwise)
      active         [cap] bool    live-granule mask (FSPA shrink)
      remaining      [A]   bool    attributes not yet selected
      theta_history  [A]   f32     Θ(D|R) after each selection (+inf unused)
      order          [A]   int32   attribute selected at each iteration (-1)
      k              []    int32   current class count K
      theta_r        []    f32     Θ(D|R) incl. PR correction (+inf initial)
      pr_correction  []    f32     FSPA PR-correction scalar
      n_selected     []    int32   |R| = iteration counter
    """

    r_ids: torch.Tensor
    h1: torch.Tensor
    h2: torch.Tensor
    active: torch.Tensor
    remaining: torch.Tensor
    theta_history: torch.Tensor
    order: torch.Tensor
    k: torch.Tensor
    theta_r: torch.Tensor
    pr_correction: torch.Tensor
    n_selected: torch.Tensor

    def where(self, keep_new: torch.Tensor, new: "SelectionState") -> "SelectionState":
        """Field by field ``new`` where ``keep_new`` (``[]``, or ``[C]``
        broadcast over each field's trailing axes), else this state."""
        def gate(old, upd):
            g = keep_new.reshape(keep_new.shape + (1,) * (upd.ndim - keep_new.ndim))
            return torch.where(g, upd, old)

        return SelectionState(*(gate(o, u) for o, u in zip(self.tensors(), new.tensors())))

    def config(self, c: int) -> "SelectionState":
        """Config ``c`` of a stacked state (views)."""
        return SelectionState(*(t[c] for t in self.tensors()))

    @staticmethod
    def stack(states: Sequence["SelectionState"]) -> "SelectionState":
        return SelectionState(*(torch.stack(ts) for ts in zip(*(s.tensors() for s in states))))


def init_state(cap: int, n_attrs: int, valid, device=None) -> SelectionState:
    """Fresh state: one class (the whole universe), nothing selected."""
    if device is None:
        device = _device_of(valid)
    active = torch.as_tensor(valid, dtype=torch.bool, device=device).reshape(cap)

    def full(shape, value, dtype):
        return torch.full(shape, value, dtype=dtype, device=device)

    return SelectionState(
        r_ids=full((cap,), 0, torch.int32),
        h1=full((cap,), 0, torch.int64),
        h2=full((cap,), 0, torch.int64),
        active=active.clone(),
        remaining=full((n_attrs,), True, torch.bool),
        theta_history=full((n_attrs,), float("inf"), torch.float32),
        order=full((n_attrs,), -1, torch.int32),
        k=full((), 1, torch.int32),
        theta_r=full((), float("inf"), torch.float32),
        pr_correction=full((), 0.0, torch.float32),
        n_selected=full((), 0, torch.int32),
    )


@dataclasses.dataclass(frozen=True)
class _Cfg:
    """Static configuration of one runner (hashable: the factory key): the
    shared evaluation strategy, the shapes and each config's measure.  A
    solo runner (one config) also holds its knobs; a stacked one takes them
    on every call (:class:`EnsembleOperands`)."""

    deltas: Tuple[str, ...]
    mode: str            # "incremental" | "spark"
    backend: str         # plan.BACKENDS
    n_attrs: int
    cap: int
    m: int
    v_max: int
    mp_chunk: int        # candidates evaluated per inner step (memory bound)
    tiles: Tuple[int, ...] = ()   # the body's kernel launch shape (plan.card_kernel), else ()
    tol: Optional[float] = None   # the solo knobs; None in a stacked runner
    tie_tol: Optional[float] = None
    shrink: Optional[bool] = None
    max_sel: Optional[int] = None  # max_features, or n_attrs when unbounded

    @classmethod
    def solo(cls, delta, mode, backend, n_attrs, cap, m, v_max, tol, tie_tol, shrink, max_sel,
             mp_chunk) -> "_Cfg":
        # numpy scalar arguments (np.int32 dims of a Granularity, np.bool_
        # flags) key as the Python values do
        return cls((str(delta),), str(mode), str(backend), int(n_attrs), int(cap), int(m),
                   int(v_max), int(mp_chunk), (), float(tol), float(tie_tol), bool(shrink),
                   int(max_sel))

    @property
    def n_cfgs(self) -> int:
        return len(self.deltas)

    @property
    def n_bins(self) -> int:
        # Static for the whole run: packed ids p = r·V + v live in [0, K·V)
        # and K ≤ cap always, so cap·V bounds every iteration.  Padding rows
        # are all-zero and contribute exactly 0 to every measure.
        return self.cap * self.v_max


class _Bins(NamedTuple):
    """A bin bound an advance packs into (the engine's is its config)."""

    n_bins: int
    v_max: int
    m: int


# ---------------------------------------------------------------------------
# collective adapters — the one seam between the two drivers
# ---------------------------------------------------------------------------


class _LocalColl:
    """Single process: every collective is the identity."""

    n_data = 1

    def psum_data(self, x):
        return x

    def gather_model(self, thetas_local, n_attrs):
        return thetas_local[:n_attrs]


class _MeshColl:
    """One rank of a mesh (:class:`repro_torch.distributed.api.Mesh`):
    granules sharded over the data axes, candidates over 'model'.

    JAX's ``psum`` over the data axes is ``dist.all_reduce`` over the mesh's
    data group, its tiled ``all_gather`` over 'model' an
    ``all_gather_into_tensor`` over the model group, and ``psum_scatter``
    along the bin axis a ``reduce_scatter_tensor`` with the bins moved to dim
    0, so shard i keeps bins ``[i·nb/nd, (i+1)·nb/nd)`` as in JAX.  The sums
    run in place on their (contiguous) argument.  Every rank must call the
    collectives in one order: the loops that drive this adapter branch only
    on replicated values (sums after the reduction, Θ after the gather).

    On the card the engine captures these collectives (NCCL) inside the
    body's CUDA graph.  Collective bytes are counted in
    ``plar_mesh_collective_bytes_total`` at each call from Python (a
    replayed CUDA graph's are not counted).
    """

    def __init__(self, mesh):
        self.daxes = mesh.data_axes
        self.n_data = mesh.n_data
        self.has_model = mesh.model_group is not None
        self.n_model = mesh.n_model
        self.model_index = mesh.model_index
        self.data_group = mesh.data_group
        self.model_group = mesh.model_group

    @staticmethod
    def bytes_counter():
        return obs.counter("plar_mesh_collective_bytes_total",
                           "bytes handed to the mesh's collectives (eager calls)")

    @classmethod
    def _count(cls, t: torch.Tensor) -> None:
        cls.bytes_counter().inc(t.numel() * t.element_size())

    def psum_data(self, x):
        if not self.daxes:
            return x
        x = x.contiguous()
        self._count(x)
        dist.all_reduce(x, group=self.data_group)
        return x

    def psum_scatter_bins(self, cont):
        """``psum_scatter(cont, daxes, scatter_dimension=1, tiled=True)``:
        ``[nc, nb, m]`` summed over the data shards, bins ``[i·nb/nd,
        (i+1)·nb/nd)`` kept on shard i."""
        bins_first = cont.transpose(0, 1).contiguous()          # [nb, nc, m]
        out = bins_first.new_empty((bins_first.shape[0] // self.n_data,) + bins_first.shape[1:])
        self._count(bins_first)
        dist.reduce_scatter_tensor(out, bins_first, group=self.data_group)
        return out.transpose(0, 1)

    def gather_data(self, x):
        """This rank's shard of a data-sharded array → the whole array
        (shards concatenated along dim 0 in data-shard order)."""
        x = x.contiguous()
        out = x.new_empty((self.n_data * x.shape[0],) + tuple(x.shape[1:]))
        self._count(x)
        dist.all_gather_into_tensor(out, x, group=self.data_group)
        return out

    def gather_model(self, thetas_local, n_attrs):
        if self.has_model:
            th = thetas_local.contiguous()
            out = th.new_empty((self.n_model * th.shape[0],))
            self._count(th)
            dist.all_gather_into_tensor(out, th, group=self.model_group)
            thetas_local = out
        return thetas_local[:n_attrs]


_LOCAL = _LocalColl()


# ---------------------------------------------------------------------------
# the shared step pieces
# ---------------------------------------------------------------------------


def _advance(at, coll, r_ids, x_col, d, w, active, n, delta: str):
    """Fold one attribute into the class ids: pack → compact → Θ → purity.

    ``at`` is the bin bound (a :class:`_Cfg`, whose ``n_bins`` is ``cap·V``,
    or :class:`_Bins`).  The host loops fold with this too, so every loop
    records Θ(D|R) from the same ops on the same shapes.
    """
    nb = at.n_bins
    packed = r_ids * at.v_max + x_col
    presence = coll.psum_data(presence_bitmap(packed, active, nb))
    new_ids, k_new = ids_from_presence(presence, packed, active)
    cont = coll.psum_data(contingency_from_ids(new_ids, d, w, active, n_bins=nb, m=at.m))
    theta = measures.evaluate(delta, cont, n)
    # purity per class → per granule (for FSPA-style shrinking)
    e = cont.sum(dim=-1)
    pure_row = (cont.amax(dim=-1) == e) & (e > 0)
    g_pure = pure_row[new_ids.to(torch.int64)] & active
    return new_ids, k_new, theta, g_pure


def _spark_thetas(delta, h1, h2, cols, x, d, w, active, n, *, n_bins, m):
    """Paper-faithful: re-key granules from scratch and sort, per candidate.

    ``h1``/``h2`` are R's fingerprints; ``h(R ∪ {a}) = h(R) + term_a``
    (mod 2³², the linear-sketch property).
    """
    out = []
    for col in cols:
        t1 = column_terms(x[:, col], col, x.shape[1], 0)
        t2 = column_terms(x[:, col], col, x.shape[1], 7919)
        ids, _k = ids_by_sort([(h2 + t2) & _MASK32, (h1 + t1) & _MASK32], active)
        cont = contingency_from_ids(ids, d, w, active, n_bins=n_bins, m=m)
        out.append(measures.evaluate(delta, cont, n))
    return torch.stack(out)


@dataclasses.dataclass
class EnsembleOperands(_Tensors):
    """Per-config parameters of the stacked engine, leading axis ``[C]``.

      tol         [C]           f32   stopping tolerance
      tie_tol     [C]           f32   argmin tie band
      max_sel     [C]           i32   max_features (n_attrs when unbounded)
      shrink      [C]           bool  FSPA universe shrinking
      theta_full  [C]           f32   Θ(D|C) stopping target (per-config w)
      n           [C]           i32   total row weight |U|
      w           [C, cap]      i32   granule weights (bagged resample seam)
      core_attrs  [C, max(A,1)] i32   forced-selection prefix, padded
      core_count  [C]           i32   number of forced selections

    Each config's measure is static: it is part of the runner's key
    (:func:`make_ensemble_run`'s ``deltas``), and each config's slice of the
    body evaluates exactly that measure.
    """

    tol: torch.Tensor
    tie_tol: torch.Tensor
    max_sel: torch.Tensor
    shrink: torch.Tensor
    theta_full: torch.Tensor
    n: torch.Tensor
    w: torch.Tensor
    core_attrs: torch.Tensor
    core_count: torch.Tensor

    @property
    def n_cfgs(self) -> int:
        return self.tol.shape[0]

    def per_config(self, fn) -> dict:
        """``fn`` of each per-config field, by name."""
        return {f.name: fn(f.name, getattr(self, f.name))
                for f in dataclasses.fields(EnsembleOperands)}


# the dtype of each EnsembleOperands field
_DTYPES = dict(tol=torch.float32, tie_tol=torch.float32, max_sel=torch.int32, shrink=torch.bool,
               theta_full=torch.float32, n=torch.int32, w=torch.int32, core_attrs=torch.int32,
               core_count=torch.int32)


@dataclasses.dataclass
class _Operands(EnsembleOperands):
    """What a body reads besides the state: each config's operands (a
    leading ``[C]`` axis, of one in a solo run) and the shared ``x [cap,
    A]``, its candidate slab ``x_t [A, cap]`` (hoisted out of the loop),
    ``d``, ``cols = arange(A)`` and ``grid``, the candidate chunks
    ``[n_chunks, nc]``.
    """

    x: torch.Tensor
    x_t: torch.Tensor
    d: torch.Tensor
    cols: torch.Tensor
    grid: torch.Tensor

    def config(self, c: int) -> "_Operands":
        """Config ``c``'s operands of a stacked set (views)."""
        return dataclasses.replace(self, **self.per_config(lambda _f, t: t[c]))


def _chunk_grid(n_attrs: int, mp_chunk: int) -> torch.Tensor:
    """Candidate chunks ``[n_chunks, nc]``, the last one wrapped around.

    ``mp_chunk`` (the paper's MP level) bounds peak memory to
    ``[mp_chunk, n_bins, m]`` per inner step; every chunk has the same
    shape, and per-candidate values are independent, so chunking never
    changes bits.
    """
    nc = max(min(mp_chunk, n_attrs), 1)
    a_pad = -(-n_attrs // nc) * nc
    return (torch.arange(a_pad, dtype=torch.int64) % max(n_attrs, 1)).reshape(-1, nc)


def _operands(cfg, x, d, device, slab, ops: EnsembleOperands) -> _Operands:
    """Host values and tensors → an :class:`_Operands` on ``device``; the
    candidate slab ``x_t`` is ``x``'s transpose, or ``slab(x)``."""
    def on(v, dtype):
        return torch.as_tensor(v, dtype=dtype).to(device)

    x = on(x, torch.int32)
    return _Operands(x=x, x_t=x.t().contiguous() if slab is None else slab(x),
                     d=on(d, torch.int32), cols=torch.arange(cfg.n_attrs, device=device),
                     grid=_chunk_grid(cfg.n_attrs, cfg.mp_chunk).to(device),
                     **ops.per_config(lambda f, v: on(v, _DTYPES[f])))


def _eval_chunk(delta: str, x_cand, r_ids, d, w, active, n, *, n_bins: int, m: int, v_max: int,
                backend: str, selector=None, tiles=None) -> torch.Tensor:
    """Θ(D|R∪{a}) of a candidate chunk, ``[nc]``: ``x_cand [nc, G]`` holds
    each candidate's column, ``r_ids`` R's class ids.  A slab backend takes
    them as they are, the others the packed ids ``r·V + v``.  The host loop
    and the engine's body evaluate every chunk here."""
    if BACKENDS[backend].slab:
        return candidate_theta(delta, None, d, w, active, n, n_bins=n_bins, m=m, backend=backend,
                               x_t=x_cand, r_ids=r_ids, v_max=v_max, selector=selector,
                               tiles=tiles)
    packed = (r_ids[None, :] * v_max + x_cand).contiguous()
    return candidate_theta(delta, packed, d, w, active, n, n_bins=n_bins, m=m, backend=backend,
                           selector=selector, tiles=tiles)


def _eval_local(cfg, delta: str, st: SelectionState, op: _Operands) -> torch.Tensor:
    """Single-process candidate evaluation: Θ(D|R∪{a}) for every a, ``[A]``."""
    if cfg.mode == "spark":
        # re-key every granule from scratch per candidate, with the
        # R-fingerprints kept in the state; the ladder does not apply
        # (sort-ranked ids are bounded by the live-granule count, not K·V)
        return _spark_thetas(delta, st.h1, st.h2, range(cfg.n_attrs), op.x, op.d, op.w,
                             st.active, op.n, n_bins=cfg.cap, m=cfg.m) + st.pr_correction
    chunks = [_eval_chunk(delta, op.x_t.index_select(0, cc), st.r_ids, op.d, op.w, st.active,
                          op.n, n_bins=cfg.n_bins, m=cfg.m, v_max=cfg.v_max,
                          backend=cfg.backend, tiles=cfg.tiles or None)
              for cc in op.grid]
    return torch.cat(chunks)[: cfg.n_attrs] + st.pr_correction


def _at(t: torch.Tensor, idx: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """``t`` at a 0-d index tensor along ``dim``, gathered on the device."""
    return t.index_select(dim, idx.reshape(1).to(torch.int64)).squeeze(dim)


def _cond(st: SelectionState, op: _Operands, n_attrs: int) -> torch.Tensor:
    """The loop condition (``[]``, or ``[C]`` on stacked operands): a forced
    pick is due, or greedy may still add an attribute.  ``theta_full + tol``
    is an f32 add, as ``measures.f32_threshold`` computes it on the host."""
    in_core = st.n_selected < op.core_count
    greedy = ((st.n_selected < n_attrs)
              & (st.theta_r > op.theta_full + op.tol)
              & (st.n_selected < op.max_sel))
    return in_core | greedy


def _select(cfg, coll, evaluate, delta: str, st: SelectionState,
            op: _Operands) -> SelectionState:
    """One greedy iteration of one config, ungated: pick (forced or masked
    argmin-with-ties), advance, shrink, record.  ``coll`` and
    ``evaluate(cfg, delta, st, op)`` are the mesh driver's seam."""
    forced = st.n_selected < op.core_count
    core_pick = _at(op.core_attrs, torch.clamp(st.n_selected, max=cfg.n_attrs - 1))
    thetas = torch.where(st.remaining, evaluate(cfg, delta, st, op), float("inf"))
    # lowest index within tie_tol of the minimum — the device twin of
    # measures.argmin_with_ties (argmax returns the first maximal index)
    in_band = (thetas <= thetas.min() + op.tie_tol).to(torch.uint8)
    best = torch.where(forced, core_pick, torch.argmax(in_band).to(torch.int32))

    new_ids, k_new, theta, g_pure = _advance(
        cfg, coll, st.r_ids, _at(op.x, best, dim=1), op.d, op.w, st.active, op.n, delta)
    theta_rec = theta + st.pr_correction          # correction *before* this fold

    if cfg.mode == "spark":
        h1 = (st.h1 + dyn_column_terms(op.x, best, 0)) & _MASK32
        h2 = (st.h2 + dyn_column_terms(op.x, best, 7919)) & _MASK32
    else:
        h1, h2 = st.h1, st.h2

    # shrink=False leaves active and pr_correction exactly unchanged
    active = st.active & ~(g_pure & op.shrink)
    if delta == "PR":
        shed = torch.where(g_pure, op.w, 0).sum().to(torch.float32)
        pr_corr = torch.where(op.shrink, st.pr_correction - shed / op.n.to(torch.float32),
                              st.pr_correction)
    else:
        pr_corr = st.pr_correction

    slot = op.cols == st.n_selected
    return SelectionState(
        r_ids=new_ids,
        h1=h1,
        h2=h2,
        active=active,
        remaining=st.remaining & (op.cols != best),
        theta_history=torch.where(slot, theta_rec, st.theta_history),
        order=torch.where(slot, best, st.order),
        k=k_new,
        theta_r=theta_rec,
        pr_correction=pr_corr,
        n_selected=st.n_selected + 1,
    )


def _body(cfg: _Cfg, coll, evaluate, op: _Operands, st: SelectionState):
    """One gated body of every config: ``(state after it, done)``.  Each
    config freezes once its own condition is false (conditions are
    monotone, so a frozen config stays frozen and its trajectory is its
    solo one); a no-op once all are.  Every branch reads replicated values
    only, so on a mesh all ranks run the same bodies."""
    go = _cond(st, op, cfg.n_attrs)                            # [C]
    new = SelectionState.stack([_select(cfg, coll, evaluate, delta, st.config(c), op.config(c))
                                for c, delta in enumerate(cfg.deltas)])
    out = st.where(go, new)
    return out, ~_cond(out, op, cfg.n_attrs).any()


# ---------------------------------------------------------------------------
# mesh evaluation: the same body over a collective adapter
# ---------------------------------------------------------------------------


def merge_candidate_cont(delta, cont, n, coll, collective: str):
    """Per-shard candidate contingency ``[nc, nb, m]`` → merged thetas [nc].

    The §3.2 collective schedules of :func:`_mesh_thetas`: ``all_reduce``
    sums the full contingency over the data shards (paper-faithful DP);
    ``reduce_scatter`` scatters contingency *rows* over the data shards,
    reduces θ locally (row-separability, Eq. 8) and sums the scalars.
    """
    nb = cont.shape[1]
    if collective == "reduce_scatter" and coll.n_data > 1 and nb % coll.n_data == 0:
        cont_slice = coll.psum_scatter_bins(cont)
        return coll.psum_data(measures.theta_rows(delta, cont_slice, n).sum(dim=-1))
    return measures.evaluate(delta, coll.psum_data(cont), n)


def _mesh_thetas(delta: str, x_cand, r_ids, d, w, active, n, coll, collective: str, *,
                 n_bins: int, m: int, v_max: int, backend: str) -> torch.Tensor:
    """This shard's candidate slab ``x_cand [nc, G_loc]`` → Θ merged over
    the data shards, ``[nc]``: the mesh twin of :func:`_eval_chunk`, for
    the engine's body and the mesh host loop's step alike.  A slab backend
    packs inside the contingency (``packed [nc, G_loc]`` is never staged)."""
    if BACKENDS[backend].slab:
        cont = sweep_contingency(x_cand, r_ids, d, w, active, v_max=v_max, n_bins=n_bins, m=m)
    else:
        cont = candidate_contingency(r_ids[None, :] * v_max + x_cand, d, w, active,
                                     n_bins=n_bins, m=m)
    return merge_candidate_cont(delta, cont, n, coll, collective)


def _mesh_cand_slab(cfg, coll, x: torch.Tensor) -> torch.Tensor:
    """This model shard's pre-transposed candidate slab ``[A_loc, G_loc]``:
    candidates ``[i·A_loc, (i+1)·A_loc)`` of model shard i, the padding
    clamped to ``n_attrs − 1``.  Built once a run, outside the loop."""
    a_loc = -(-cfg.n_attrs // coll.n_model)
    midx = coll.model_index if coll.has_model else 0
    cand = torch.clamp(midx * a_loc + torch.arange(a_loc, device=x.device), max=cfg.n_attrs - 1)
    return x.index_select(1, cand).t().contiguous().to(torch.int32)


def _eval_mesh(coll, collective: str, cfg, delta: str, st: SelectionState,
               op: _Operands) -> torch.Tensor:
    """Mesh candidate evaluation: this shard's slab ``op.x_t`` (see
    :func:`_mesh_cand_slab`) → Θ gathered over 'model', ``[A]``.

    Every body evaluates at the top rung ``cfg.n_bins = cap·V`` (``cap`` the
    mesh's whole capacity, ``nd·cap_per_shard``, so ``reduce_scatter``
    tiles), as the solo engine does (module doc).
    """
    th_loc = _mesh_thetas(delta, op.x_t, st.r_ids, op.d, op.w, st.active, op.n, coll,
                          collective, n_bins=cfg.n_bins, m=cfg.m, v_max=cfg.v_max,
                          backend=cfg.backend)
    return coll.gather_model(th_loc, cfg.n_attrs) + st.pr_correction


# ---------------------------------------------------------------------------
# the loop: a body captured once and replayed (card), or run eagerly (CPU)
# ---------------------------------------------------------------------------


_graph_pools = {}


def _graph_pool(device: torch.device):
    """One memory pool for every engine graph on ``device``.

    A body keeps nothing it allocates past its end (its results are copied
    into the runner's own buffers), so the graphs may share their
    temporaries: the pool holds the largest body's, not the sum of all.
    """
    key = torch.device(device).index or 0
    if key not in _graph_pools:
        _graph_pools[key] = torch.cuda.graph_pool_handle()
    return _graph_pools[key]


def release_graphs() -> None:
    """Drop every cached runner, with its CUDA graph and buffers, and return
    the engine's graph memory to the card (the factories hold their runners
    for the life of the process)."""
    _runner.cache_clear()
    _graph_pools.clear()
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def _launches() -> int:
    """Θ kernel launches made from Python so far (``ops.LAUNCHES``, all
    three kernels); a graph's replays make none, so a captured body's are
    counted once, at its capture."""
    from repro_torch.kernels.contingency.ops import LAUNCHES

    return sum(LAUNCHES.values())


def _drive(body, done: torch.Tensor, max_bodies: int, period: int) -> Tuple[int, int]:
    """Run ``body`` until ``done`` reads set or ``max_bodies`` ran.

    After every ``period`` bodies the flag is copied, without blocking, into
    pinned host memory; the host then waits only for the copy of the group
    before, so the card always has the latest group queued.  Bodies run
    after the stop are exact no-ops.  Returns ``(bodies, polls)``.
    """
    cuda = done.is_cuda
    flags = torch.zeros((2,), dtype=torch.bool, pin_memory=cuda)
    events = [torch.cuda.Event(), torch.cuda.Event()] if cuda else None
    bodies = polls = 0
    prev = None
    while bodies < max_bodies:
        for _ in range(min(period, max_bodies - bodies)):
            body()
            bodies += 1
        slot = polls % 2
        flags[slot].copy_(done, non_blocking=cuda)
        if cuda:
            events[slot].record()
        polls += 1
        if prev is not None:
            if cuda:
                events[prev].synchronize()
            if bool(flags[prev]):
                break
        prev = slot
    return bodies, polls


class _Loop:
    """The engine's while loop for one runner: static buffers (state and
    operands) per device, the body captured as a CUDA graph at the first
    call on a card, then replayed; on the CPU the same body runs eagerly.

    Every caller of a config shares its buffers, so calls of one runner must
    not overlap: callers on several threads serialize their dispatches (the
    service's handles hold ``device_guard(device).dispatch``).
    """

    def __init__(self, body):
        self._body = body          # (operands, state) -> (state, done)
        self._slots = {}
        self.captures = 0          # CUDA graphs captured (the engine's compiles)
        self.capture_s = 0.0
        self.last_bodies = 0
        self.last_polls = 0
        self.last_launches = 0     # Θ kernel launches the last call's bodies held

    def _step(self, slot) -> None:
        new, done = self._body(slot["op"], slot["st"])
        slot["st"].copy_(new)
        slot["done"].copy_(done)

    def _capture(self, slot, st_in: SelectionState) -> None:
        t0 = time.perf_counter()
        dev = slot["st"].r_ids.device
        # no other thread may sync or allocate on the card while the capture
        # runs (global capture mode): the device guard keeps the service's
        # merges, builds and snapshots out until it ends (core/guard.py)
        with device_guard(dev).exclusive():
            # one eager body on a side stream first (lazy library state is
            # created outside the capture), then the state is put back
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                self._step(slot)
            torch.cuda.current_stream().wait_stream(side)
            slot["st"].copy_(st_in)
            graph = torch.cuda.CUDAGraph()
            launches0 = _launches()
            with torch.cuda.graph(graph, pool=_graph_pool(dev)):
                self._step(slot)
            torch.cuda.synchronize()
        slot["graph"] = graph
        slot["launches"] = _launches() - launches0
        self.captures += 1
        self.capture_s += time.perf_counter() - t0

    def __call__(self, op: _Operands, st: SelectionState, max_bodies: int) -> SelectionState:
        dev = st.r_ids.device
        slot = self._slots.get(dev)
        if slot is None:
            slot = self._slots[dev] = {
                "op": op.clone(), "st": st.clone(),
                "done": torch.zeros((), dtype=torch.bool, device=dev), "graph": None,
                "launches": 0}
        else:
            # copied in before every call: a graph replays what its buffers
            # hold, never the values of its first call
            slot["op"].copy_(op)
            slot["st"].copy_(st)
        slot["done"].zero_()
        if dev.type == "cuda":
            if slot["graph"] is None:
                self._capture(slot, st)
            body = slot["graph"].replay
        else:
            body = partial(self._step, slot)
        self.last_bodies, self.last_polls = _drive(body, slot["done"], max_bodies, POLL_PERIOD)
        self.last_launches = slot["launches"] * self.last_bodies   # 0 on an eager slot
        return slot["st"].clone()


# ---------------------------------------------------------------------------
# public entry points (cached per static config → one capture each)
# ---------------------------------------------------------------------------


def body_tiles(backend: str, delta: str, n_attrs: int, cap: int, m: int, v_max: int,
               mp_chunk: int, selector: str, device=None) -> Tuple[int, ...]:
    """The launch shape of the CUDA kernel a body launches on ``device``
    (:func:`~.plan.card_kernel`), resolved for it (the first candidate
    chunk's shape: every chunk takes it); ``()`` where the body launches
    none."""
    kernel = card_kernel(backend, device)
    if kernel is None:
        return ()
    from repro_torch.kernels.contingency.autotune import resolve_tiles

    return resolve_tiles(kernel, nc=max(min(int(mp_chunk), int(n_attrs)), 1), g=int(cap),
                         n_bins=int(cap) * int(v_max), m=int(m), v_max=int(v_max),
                         delta=str(delta), selector=selector, device=device)


class _Runner:
    """The runner of one :class:`_Cfg`: the gated body over its configs,
    looped by :class:`_Loop` (``loop``) or run once eagerly (``step``).

    A solo config (one measure, its knobs in the config) is called as
    ``run(st, x, d, w, n, theta_full, core_attrs, core_count) -> final
    state`` on an unstacked state, a grid of one inside; a stacked one as
    ``run(st_stack, x, d, ops) -> st_stack``, every state field with a
    leading ``[C]`` and ``ops`` the :class:`EnsembleOperands`.  Over a mesh
    (``mesh``, ``collective``) each rank passes its shard of ``x``/``d``/
    ``w`` and of the state's granule fields, and the replicated rest.
    """

    def __init__(self, cfg: _Cfg, mesh=None, collective=None):
        self.cfg = cfg
        if mesh is None:
            coll, evaluate, self._slab = _LOCAL, _eval_local, None
        else:
            coll = _MeshColl(mesh)
            evaluate = partial(_eval_mesh, coll, collective)
            self._slab = partial(_mesh_cand_slab, cfg, coll)
        body = partial(_body, cfg, coll, evaluate)
        self.loop = _Loop(body)
        # one greedy iteration (evaluate → argmin → advance), run eagerly
        self.step = partial(self._call, lambda op, st, _max_bodies: body(op, st)[0])

    def __call__(self, st, x, d, *args) -> SelectionState:
        return self._call(self.loop, st, x, d, *args)

    def _call(self, run, st, x, d, *args) -> SelectionState:
        cfg, dev = self.cfg, st.r_ids.device
        if cfg.tol is None:
            (ops,) = args
            if ops.n_cfgs != cfg.n_cfgs:
                raise ValueError(f"{ops.n_cfgs} operand configs for a runner of {cfg.n_cfgs}")
            op = _operands(cfg, x, d, dev, self._slab, ops)
            bounds = (op.core_count.to(torch.int64) + op.max_sel.clamp(min=0)).tolist()
            return run(op, st, min(cfg.n_attrs, max(bounds)))
        w, n, theta_full, core_attrs, core_count = args
        ops = EnsembleOperands(*(torch.as_tensor(v)[None] for v in (
            cfg.tol, cfg.tie_tol, cfg.max_sel, cfg.shrink, theta_full, n, w, core_attrs,
            core_count)))
        op = _operands(cfg, x, d, dev, self._slab, ops)
        # no run needs more bodies: every live one selects an attribute
        max_bodies = min(cfg.n_attrs, int(core_count) + max(cfg.max_sel, 0))
        return run(op, SelectionState.stack([st]), max_bodies).config(0)


@lru_cache(maxsize=None)
def _runner(cfg: _Cfg, mesh=None, collective=None) -> _Runner:
    """The one cached factory: one runner, so one CUDA graph capture, per
    config (and mesh) and device, whatever the data (operands are copied
    into the runner's buffers on every call)."""
    if cfg.tol is None:
        obs.counter("plar_engine_ensemble_factories_total",
                    "distinct stacked-engine configs traced").inc()
    else:
        obs.counter("plar_engine_run_factories_total",
                    "distinct while_loop engine configs traced").inc()
    return _Runner(cfg, mesh, collective)


def runner_for(cfg: _Cfg, selector: str = "analytic", device=None) -> _Runner:
    """The runner of a solo ``cfg``, its kernel launch shape ``cfg.tiles``
    or (empty) resolved by ``selector`` for ``device`` (:func:`body_tiles`):
    a body captured with other tiles is never replayed for these."""
    if not cfg.tiles:
        cfg = dataclasses.replace(cfg, tiles=body_tiles(
            cfg.backend, cfg.deltas[0], cfg.n_attrs, cfg.cap, cfg.m, cfg.v_max, cfg.mp_chunk,
            selector, device))
    return _runner(cfg)


def make_engine_run(delta: str, mode: str, backend: str, n_attrs: int, cap: int, m: int,
                    v_max: int, tol: float, tie_tol: float, shrink: bool, max_sel: int,
                    mp_chunk: int = 64, ladder: bool = False, selector: str = "analytic",
                    tiles: Sequence[int] = (), device=None):
    """The full reduction as one device-resident loop (single process):
    ``run(st, x, d, w, n, theta_full, core_attrs, core_count) -> final
    state``, cached per normalized config (:func:`runner_for`)."""
    cfg = _Cfg.solo(delta, mode, backend, n_attrs, cap, m, v_max, tol, tie_tol, shrink, max_sel,
                    mp_chunk)
    return runner_for(dataclasses.replace(cfg, tiles=tuple(int(t) for t in tiles)), selector,
                      device)


def make_engine_step(*args, **kwargs):
    """One greedy iteration (evaluate → argmin → advance), for inspection:
    the body that ``make_engine_run`` of the same arguments loops, with its
    call signature."""
    return make_engine_run(*args, **kwargs).step


def make_engine_run_mesh(mesh, collective: str, delta: str, backend: str, n_attrs: int,
                         cap: int, m: int, v_max: int, tol: float, tie_tol: float, max_sel: int,
                         ladder: bool = False, selector: str = "analytic"):
    """The mesh reduction as one device-resident loop on each rank of
    ``mesh`` (``collective``: ``all_reduce`` or ``reduce_scatter``).

    ``cap`` is the mesh's whole granule capacity (``nd · cap_per_shard``):
    class ids are dense over all shards, so ``cap·V`` bounds every packed
    id.  The mode is ``incremental``, there is no shrinking, and
    ``mp_chunk`` is inert (the 'model' axis is the MP level).  Cached per
    mesh and config: one capture per config on a card.
    """
    cfg = _Cfg.solo(delta, "incremental", backend, n_attrs, cap, m, v_max, tol, tie_tol, False,
                    max_sel, n_attrs)
    return _runner(cfg, mesh, str(collective))


def _forced_attrs(n_attrs: int, forced) -> np.ndarray:
    """The padded ``[max(A, 1)]`` forced-selection buffer (core attributes
    and warm-start prefixes alike)."""
    arr = np.zeros((max(n_attrs, 1),), np.int32)
    arr[: len(forced)] = forced
    return arr


def init_state_from_reduct(runner, cap: int, n_attrs: int, valid, x, d, w, n,
                           prefix) -> SelectionState:
    """Seed a :class:`SelectionState` by folding ``prefix`` into fresh state.

    Runs the runner's loop with the greedy phase disabled (``theta_full =
    +inf`` makes the greedy condition false), so it executes exactly
    ``len(prefix)`` forced folds.  The state carries the refined ``r_ids``
    / ``k``, the Θ-history prefix recomputed on this granularity, and
    ``remaining`` with the prefix cleared — ready for :func:`engine_resume`.
    ``theta_full`` is an operand, so seeding captures nothing new.
    """
    st = init_state(cap, n_attrs, valid, device=_device_of(x, valid))
    return runner(st, x, d, w, n, float("inf"), _forced_attrs(n_attrs, prefix), len(prefix))


def engine_resume(runner, st: SelectionState, x, d, w, n, theta_full):
    """Resume the greedy loop from a seeded state (no forced selections)."""
    n_attrs = st.remaining.shape[0]
    return runner(st, x, d, w, n, float(theta_full), _forced_attrs(n_attrs, ()), 0)


def _device_of(*tensors) -> torch.device:
    return next((t.device for t in tensors if isinstance(t, torch.Tensor)), torch.device("cpu"))


def run_engine(runner, cap: int, n_attrs: int, valid, x, d, w, n, theta_full: float, core,
               warm_start=None):
    """Init state → loop → unpack: the device path of ``plar_reduce``.

    With ``warm_start`` (a prefix; ``core`` must be empty) the loop is
    seeded by :func:`init_state_from_reduct` and resumed by
    :func:`engine_resume` — two calls of the same runner.

    Returns ``(reduct, theta_history, iterations, n_evals,
    per_iteration_s)``; ``per_iteration_s`` holds one entry per executed
    body (``len(reduct)``, forced folds included), each the loop average.
    The ``engine.dispatch`` span records the bodies replayed, the ``done``
    polls, the captures of the run and the Θ kernel launches the replayed
    bodies held (``theta_launches``; 0 on the CPU, where no body is
    captured).
    """
    loop = runner.loop
    captures_before, capture_s_before = loop.captures, loop.capture_s
    t_loop = time.perf_counter()
    with obs.span("engine.dispatch", n_attrs=n_attrs, cap=cap,
                  warm=warm_start is not None) as sp:
        if warm_start is not None:
            if core:
                raise ValueError("warm_start replaces the core prefix")
            forced = list(warm_start)
            st = init_state_from_reduct(runner, cap, n_attrs, valid, x, d, w, n, forced)
            bodies, polls, launches = loop.last_bodies, loop.last_polls, loop.last_launches
            fin = engine_resume(runner, st, x, d, w, n, theta_full)
        else:
            forced = list(core)
            bodies = polls = launches = 0
            st = init_state(cap, n_attrs, valid, device=_device_of(x, valid))
            fin = runner(st, x, d, w, n, theta_full, _forced_attrs(n_attrs, forced), len(forced))
        bodies += loop.last_bodies
        polls += loop.last_polls
        launches += loop.last_launches
        reduct, hist, iters, n_evals = unpack_result(fin, len(forced))
        loop_s = time.perf_counter() - t_loop
        compiled = loop.captures > captures_before
        sp.set(k=len(reduct), iterations=iters, compiled=compiled, bodies=bodies,
               polls=polls, captures=loop.captures - captures_before,
               capture_s=loop.capture_s - capture_s_before, loop_s=loop_s,
               theta_launches=launches)
    obs.counter("plar_engine_runs_total",
                "engine while_loop dispatch sequences completed").inc()
    if compiled:
        obs.counter("plar_engine_compiles_total",
                    "engine dispatches that paid a fresh trace/compile").inc()
    obs.gauge("plar_engine_last_k",
              "reduct size of the most recent engine run").set(len(reduct))
    obs.gauge("plar_engine_last_iterations",
              "greedy iterations of the most recent engine run").set(iters)
    n_bodies = len(reduct)
    per_body = loop_s / n_bodies if n_bodies else 0.0
    if n_bodies:
        obs.histogram("plar_engine_iteration_seconds",
                      "loop-average seconds per executed engine loop body").observe(per_body)
    return reduct, hist, iters, n_evals, [per_body] * n_bodies


def unpack_result(fin: SelectionState, core_count: int):
    """Host-side unpack of a solo state: (reduct, theta_history,
    greedy_iterations, n_evals), :func:`unpack_ensemble_result`'s one
    device→host transfer for a grid of one."""
    return unpack_ensemble_result(SelectionState(*(t[None] for t in fin.tensors())),
                                  [core_count])[0]


# ---------------------------------------------------------------------------
# stacked multi-config engine (DESIGN.md §3.8)
# ---------------------------------------------------------------------------


def make_ensemble_run(mode: str, backend: str, deltas: Sequence[str], n_attrs: int, cap: int,
                      m: int, v_max: int, mp_chunk: int = 64, ladder: bool = False,
                      selector: str = "analytic", device=None):
    """The whole config grid as one loop (one capture per grid and device).

    Returns ``run(st_stack, x, d, ops) -> st_stack`` where every
    :class:`SelectionState` field carries a leading ``[len(deltas)]`` axis
    and ``ops`` is the :class:`EnsembleOperands` stack.  ``deltas`` names
    each config's measure.  A kernel the body launches on ``device`` takes
    one launch shape for every member (:func:`body_tiles`, resolved for the
    first measure: tiles change no bit), part of the runner's key.
    """
    check_stacked(backend, ladder)
    deltas = tuple(str(dd) for dd in deltas)
    bad = [dd for dd in deltas if dd not in ENSEMBLE_DELTAS]
    if bad:
        raise ValueError(f"unknown measures {bad} (one of: {', '.join(ENSEMBLE_DELTAS)})")
    tiles = body_tiles(backend, deltas[0], n_attrs, cap, m, v_max, mp_chunk, selector, device)
    return _runner(_Cfg(deltas, str(mode), str(backend), int(n_attrs), int(cap), int(m),
                        int(v_max), int(mp_chunk), tuple(int(t) for t in tiles)))


def init_ensemble_state(cap: int, n_attrs: int, valid, n_cfgs: int, device=None) -> SelectionState:
    """Fresh stacked state: :func:`init_state` repeated on a leading [C]."""
    return SelectionState.stack([init_state(cap, n_attrs, valid, device)] * n_cfgs)


def run_ensemble(runner, cap: int, n_attrs: int, valid, x, d, ops: EnsembleOperands):
    """Init stacked state → one loop → final stacked state.

    Returns ``(final_state, loop_s)``; unpack per config with
    :func:`unpack_ensemble_result`.
    """
    loop = runner.loop
    captures_before, capture_s_before = loop.captures, loop.capture_s
    t0 = time.perf_counter()
    with obs.span("engine.dispatch_ensemble", configs=ops.n_cfgs, n_attrs=n_attrs,
                  cap=cap) as sp:
        st = init_ensemble_state(cap, n_attrs, valid, ops.n_cfgs, device=_device_of(x, valid))
        fin = runner(st, x, d, ops)
        if fin.n_selected.is_cuda:
            torch.cuda.synchronize(fin.n_selected.device)   # the loop's time, not its enqueue
        sp.set(compiled=loop.captures > captures_before, bodies=loop.last_bodies,
               polls=loop.last_polls, captures=loop.captures - captures_before,
               capture_s=loop.capture_s - capture_s_before,
               theta_launches=loop.last_launches)
    obs.counter("plar_engine_ensemble_runs_total",
                "stacked-engine dispatches completed").inc()
    return fin, time.perf_counter() - t0


def unpack_ensemble_result(fin: SelectionState, core_counts) -> List[tuple]:
    """Stacked final state → per-config (reduct, theta_history, iterations,
    n_evals), in one device→host transfer for the whole grid.  The engine
    evaluates all A candidates each greedy iteration (selected ones are
    masked after the fact): ``n_evals`` counts them.  The f32 history
    travels as its int32 bits."""
    n_cfgs, n_attrs = fin.order.shape
    flat = to_host(torch.cat([fin.order.reshape(-1), fin.theta_history.reshape(-1).view(
        torch.int32), fin.n_selected.reshape(-1)])).numpy()
    order = flat[:n_cfgs * n_attrs].reshape(n_cfgs, n_attrs)
    hist = flat[n_cfgs * n_attrs: 2 * n_cfgs * n_attrs].view(np.float32).reshape(n_cfgs, n_attrs)
    nsel = flat[2 * n_cfgs * n_attrs:]
    out = []
    for c, cc in enumerate(core_counts):
        ns = int(nsel[c])
        iters = ns - int(cc)
        out.append(([int(a) for a in order[c, :ns]], [float(t) for t in hist[c, :ns]],
                    iters, iters * n_attrs))
    return out
