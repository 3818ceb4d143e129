"""The production dry-run on the port (the port of ``repro.launch.dryrun``):
every (arch × shape × mesh) LM cell, and PLAR's own cell.

    python -m repro_torch.launch.dryrun --arch tinyllama-1.1b --shape train_4k --mesh single
    python -m repro_torch.launch.dryrun --all --mesh both --out runs/dryrun
    python -m repro_torch.launch.dryrun --plar --mesh single|multi \
        [--collective all_reduce|reduce_scatter] [--table-dtype int32|int8] \
        [--fused-pack] [--out DIR] [--tag NAME] [--execute] [--device cuda|cpu]

``--all`` spawns one subprocess a cell and skips cells whose JSON exists
(``--force`` reruns them), as JAX's.  ``--override k=v`` replaces an
``ArchConfig`` field, ``--microbatches N`` splits train_4k's batch.

**The LM cells** (:func:`run_cell`).  JAX lowers and compiles each cell for
256 or 512 placeholder devices and reads XLA's memory and cost analyses
and the HLO's collectives.  The port cannot compile for XLA: it runs the
same step once, eagerly, as rank 0 of a fake world of
:func:`~repro_torch.launch.mesh.make_production_mesh`'s size (PyTorch's
``"fake"`` process-group backend: (16, 16) ``data × model``, or (2, 16, 16)
``pod × data × model``), on the ``meta`` device
(:func:`repro_torch.device.modelling`: full-size shapes, no memory), and
counts what that rank would allocate, compute, move and communicate with
:class:`~repro_torch.launch.roofline.StepCounter`.  The hand-written
kernels run as shape-only twins that hand their analytic costs to the
counter (counted in their ``MODELLED`` counters, never in ``LAUNCHES``).
The record keeps JAX's keys:

* ``memory_per_device``: ``argument_bytes`` (the rank's shards of the
  step's arguments), ``output_bytes`` (of its results), ``temp_bytes`` (the
  high-water mark of the storages the step allocates, less the results it
  still holds at the end), ``alias_bytes`` (results that are arguments
  updated in place: the donated state, as the port's train step updates
  the parameters and moments in place, and the decode cache), and
  ``total_hbm_bytes`` = arg + out + temp − alias.  Eager PyTorch frees a
  buffer when its last reference goes, with no reuse plan; the caching
  allocator's rounding and fragmentation are not modelled (``memory_model``);
* ``flops_per_device`` from the ``attn_naive=True`` run (every flop
  visible, as JAX's naive probes), ``bytes_per_device``,
  ``convert_bytes_per_device`` and ``collectives`` from the production path
  (the twins), both with ``remat=False`` as JAX's probe configs, and
  ``scanned_cost`` and the memory from the step as configured.  JAX counts
  1- and 2-period probes and extrapolates (its scanned loop hides the
  layers from XLA's cost analysis); eager PyTorch hides no loop, so the
  port counts the **full-depth** step directly (``roofline.extrapolate``
  of its own 1- and 2-period counts gives the same numbers);
* ``collectives``: counts, payloads, result and ring wire bytes by kind,
  and ``total_wire_bytes_per_device``;
* ``roofline``: :func:`~repro_torch.launch.roofline.roofline_terms` on the
  fixed H100 SXM spec (bf16), named in ``roofline_spec``;
* ``model_flops_total``, ``model_flops_per_device``, ``useful_flops_ratio``,
  ``status`` (``skipped`` with JAX's reason where ``shape_applies`` says
  so; ``error`` with the traceback when a cell fails);
* ``modelled: true``, ``compile_s: null`` and ``count_s`` (the seconds of
  the counted runs).  JAX's ``bytes_per_device_tpu_corrected`` and
  ``roofline_tpu_corrected`` correct for a TPU's fusion of casts and have
  no meaning for eager CUDA: left out.

**PLAR's cell** (:func:`run_plar_cell`, ``--plar``).  The cell is JAX's:
one PLAR greedy iteration at SDSS scale, G 327,680 granules x A 5,216
candidate attributes (320,000 x 5,201 padded to shard multiples), V 8, M
17 classes, K 64 classes of the reduct mid-loop (n_bins = K·V = 512), SCE;
candidates over ``model``, granules over ``(pod, data)`` of
:func:`~repro_torch.launch.mesh.make_production_mesh`: (16, 16) on one
pod, (2, 16, 16) on two.  One rank's shard is G/n_data x A/n_model:
20,480 x 326 on one pod, 10,240 x 326 on two.

JAX lowers and compiles the step for 256 or 512 placeholder devices and
reads XLA's memory and cost analyses.  For this cell the port starts no
world, not even a fake one: it models the record analytically from the
shard shapes of its own steps and keeps JAX's keys:

* ``memory_per_device``: the arguments of the port's ``_eval_step``
  (``repro_torch/core/distributed.py``) at one rank's shard (the rank holds
  its data shard of every column, as JAX's ``P(daxes, None)``), its output
  (Θ gathered over ``model``) and its named intermediates, summed with no
  buffer reuse (``temps`` names each).  It is not XLA's exact analysis:
  the elementwise intermediates of the segment-id chain and of θ, and the
  fused kernel's workspace, are not listed, so the peak can exceed
  ``temp_bytes``; the record says so in ``memory_model``, and an executed
  record gives the measured peak over the shard's modelled temporaries;
* ``flops_per_device`` / ``bytes_per_device``: the pack, segment-id and
  scatter-add operations over the shard and θ over the contingency; each
  input read once, each output written once, and the contingency written
  and read once where the step materializes it (all but ``fused``);
* ``collectives``: the payloads that ``_MeshColl`` hands to each collective
  (the bytes ``plar_mesh_collective_bytes_total`` counts) and their wire
  bytes under a ring model over the group (n = 16 data x 16 model ranks,
  32 x 16 on two pods): ``all_reduce`` 2(n−1)/n·B, ``reduce_scatter``
  (n−1)/n·B, ``all_gather`` (n−1)·B_shard;
* ``roofline``: :func:`~repro_torch.launch.roofline.roofline_terms` on the
  fixed H100 SXM :class:`~repro_torch.launch.roofline.DeviceSpec`, or on the
  card's own when ``execute`` runs on one, float32 operations; the record
  names it (JAX's was a TPU's), and a modelled record does not depend on
  the machine;
* ``compile_s``: ``null`` for a modelled record; with ``execute=True`` the
  seconds of the first call at the shard shape (the kernels' build and the
  first launch).

``execute=True`` (``--execute``) runs one rank's evaluation step and then
its advance step for real at the shard shape, as a world of one rank (mesh
(1, 1); NCCL on the card, gloo on the CPU), and adds ``executed``: the
step's device ms (CUDA events, the median of :data:`REPS` calls), the
advance step's, the measured peak memory around the step, and Θ against the
port's solo evaluation of the same shard (the step's, and the advance's of
the candidate it folds).  At one data shard the
``reduce_scatter`` merge is the ``all_reduce`` one, as in JAX.
``collective="fused"`` runs the fused Θ schedule (the CUDA fused-Θ
kernel's raw partial on the card); JAX's CLI has no flag for it, so it is a
keyword of :func:`run_plar_cell` only.  ``--fused-pack`` is
``backend="sweep_xla"`` on ``_eval_step``.

A modelled record touches no device and needs no card; only ``--execute``
needs ``--device`` (default ``cuda``: no card is an error).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
from typing import Dict, List, Optional

import numpy as np

from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.roofline import collective_stats as _stats
from repro_torch.launch.roofline import ring_wire_bytes

__all__ = ["PlarCell", "run_cell", "run_plar_cell", "count_step", "fake_world",
           "model_eval_collectives", "model_advance_collectives", "model_memory", "model_cost",
           "ring_wire_bytes", "shard_operands", "main"]

COLLECTIVES = ("all_reduce", "reduce_scatter", "fused")
DELTA = "SCE"                      # the cell's measure, as JAX's
TABLE_DTYPES = {"int32": 4, "int8": 1}
REPS = 7                           # timed calls of an executed step (the median is kept)
MEMORY_MODEL = ("the step's arguments, output and named temporaries at the shard shape, "
                "summed with no reuse; not an exact analysis: the elementwise "
                "intermediates of the segment-id chain and of θ, and the fused kernel's "
                "workspace, are not listed, so the peak can exceed temp_bytes")
LM_MEMORY_MODEL = ("one eager step on the meta device as rank 0 of a fake world: the rank's "
                   "argument shards, its results, and the high-water mark of the storages "
                   "the step allocates (freed when their last reference goes); the caching "
                   "allocator's rounding and fragmentation are not modelled")
SKIP_REASON = "long_500k requires sub-quadratic attention (DESIGN.md §4)"
PROBE = dict(scan_unroll=True, remat=False)     # JAX's probe configs, at full depth


@dataclasses.dataclass(frozen=True)
class PlarCell:
    """The PLAR cell's shape and its mesh: G granules x A candidates, V
    values, M classes, K reduct classes; ``n_data`` granule shards and
    ``n_model`` candidate shards."""

    G: int = 327_680
    A: int = 5_216
    V: int = 8
    M: int = 17
    K: int = 64
    n_data: int = 16
    n_model: int = 16

    @property
    def n_bins(self) -> int:
        return self.K * self.V

    @property
    def g_loc(self) -> int:
        return self.G // self.n_data

    @property
    def a_loc(self) -> int:
        return self.A // self.n_model

    @classmethod
    def production(cls, mesh_kind: str) -> "PlarCell":
        """JAX's SDSS cell on :func:`make_production_mesh`'s layout."""
        layout = _build_mesh(mesh_kind)
        return cls(n_data=layout.n_data, n_model=layout.n_model)


def _build_mesh(kind: str):
    if kind not in ("single", "multi"):
        raise ValueError(f"unknown mesh kind {kind!r} (one of: single, multi)")
    return make_production_mesh(multi_pod=(kind == "multi"))


def model_eval_collectives(cell: PlarCell, collective: str) -> Dict:
    """The collectives one rank's ``_eval_step`` issues, in order: the data
    merge, then Θ gathered over ``model`` (``[A_loc]`` f32)."""
    cont = cell.a_loc * cell.n_bins * cell.M * 4
    theta = cell.a_loc * 4
    nd, nm = cell.n_data, cell.n_model
    if collective == "fused":
        calls = [("all_reduce", theta, nd)]
    elif collective == "reduce_scatter" and nd > 1 and cell.n_bins % nd == 0:
        calls = [("reduce_scatter", cont, nd), ("all_reduce", theta, nd)]
    elif collective in ("all_reduce", "reduce_scatter"):
        calls = [("all_reduce", cont, nd)]
    else:
        raise ValueError(f"unknown collective {collective!r} (one of: {', '.join(COLLECTIVES)})")
    calls.append(("all_gather", theta, nm))
    return _stats(calls)


def model_advance_collectives(cell: PlarCell) -> Dict:
    """The advance step's: the presence bitmap (``[n_bins]`` int32) and the
    winner's contingency (``[n_bins, M]`` f32), each summed over data."""
    return _stats([("all_reduce", cell.n_bins * 4, cell.n_data),
                   ("all_reduce", cell.n_bins * cell.M * 4, cell.n_data)])


def model_memory(cell: PlarCell, collective: str, *, table_dtype: str = "int32",
                 fused_pack: bool = False) -> Dict:
    """Bytes of one rank's evaluation step at its shard: arguments, output
    and named intermediates (summed, no buffer reuse)."""
    isz = TABLE_DTYPES[table_dtype]
    g, a, A, nb, m = cell.g_loc, cell.a_loc, cell.A, cell.n_bins, cell.M
    args = {"cand": A * 4, "r_ids": g * 4, "x": g * A * isz, "d": g * isz, "w": g * 4,
            "valid": g, "n": 4}
    temps = {"x_gather": g * a * isz}
    if isz != 4:
        temps["x_cand"] = a * g * 4
    if collective == "fused":
        temps.update(packed=a * g * 4, w_f32=g * 4, raw=a * 4)
    else:
        if not fused_pack:
            temps["packed"] = a * g * 4
        temps.update(segment_ids=2 * a * g * 8, contingency=2 * a * (nb * m + 1) * 4,
                     theta_rows=a * nb * m * 4)
        if collective == "reduce_scatter" and cell.n_data > 1 and nb % cell.n_data == 0:
            temps.update(bins_major=a * nb * m * 4, scattered=a * (nb // cell.n_data) * m * 4)
    return {"argument_bytes": sum(args.values()), "output_bytes": A * 4,
            "temp_bytes": sum(temps.values()), "arguments": args, "temps": temps}


def model_cost(cell: PlarCell, collective: str, *, table_dtype: str = "int32") -> Dict:
    """Operations and bytes of one rank's evaluation step (module doc)."""
    isz = TABLE_DTYPES[table_dtype]
    g, a, nb, m = cell.g_loc, cell.a_loc, cell.n_bins, cell.M
    elems = a * g
    flops = 5.0 * elems + 4.0 * a * nb * m      # pack 2 + segment id 2 + add 1; θ ~4 a cell
    nbytes = elems * isz + g * (4 + isz + 4 + 1) + cell.A * 4
    if collective != "fused":
        nbytes += 2 * a * nb * m * 4             # the contingency written, then read by θ
    return {"flops": flops, "bytes": float(nbytes)}


# ---------------------------------------------------------------------------
# one rank's steps, executed
# ---------------------------------------------------------------------------


def shard_operands(cell: PlarCell, *, seed: int = 0, table_dtype: str = "int32"):
    """The whole cell's table from ``seed`` (numpy): ``x [G, A]``, ``r_ids``
    (K classes of G/K granules each, in order, so no class straddles a data
    shard when K is a multiple of ``n_data``: the placement the ``fused``
    schedule's driver makes), ``d``, ``w`` (multiplicities 1..4), ``valid``
    (all live)."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, cell.V, (cell.G, cell.A), dtype=np.int32)
    r_ids = (np.arange(cell.G, dtype=np.int64) * cell.K // cell.G).astype(np.int32)
    d = rng.integers(0, cell.M, cell.G, dtype=np.int32)
    w = rng.integers(1, 5, cell.G, dtype=np.int32)
    valid = np.ones(cell.G, bool)
    if table_dtype == "int8":
        x, d = x.astype(np.int8), d.astype(np.int8)
    return x, r_ids, d, w, valid


def _solo_theta(delta, x, r_ids, d, w, valid, n, cell: PlarCell):
    """The port's solo evaluation (``segment``) of every candidate of ``x``."""
    import torch

    from repro_torch.core.granularity import pack_ids
    from repro_torch.core.plan import candidate_theta

    packed = pack_ids(r_ids[None, :], x.t().to(torch.int32), cell.V).contiguous()
    return candidate_theta(delta, packed, d.to(torch.int32), w, valid, n,
                           n_bins=cell.n_bins, m=cell.M, backend="segment")


def _median_ms(torch, fn) -> float:
    """Median CUDA-event ms of :data:`REPS` calls (one warm-up before)."""
    fn()
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def execute_shard(cell: PlarCell, collective: str, *, table_dtype: str = "int32",
                  fused_pack: bool = False, device="cuda") -> Dict:
    """One rank's evaluation and advance steps at the shard shape, on a world
    of one rank, mesh (1, 1): NCCL on the card, gloo on the CPU.  Starts
    (and afterwards destroys) the process group unless one is running."""
    import torch
    import torch.distributed as dist

    from repro_torch.core.distributed import _advance_step, _eval_step
    from repro_torch.core.engine import _MeshColl
    from repro_torch.device import resolve_device
    from repro_torch.distributed.api import init_process_group, make_mesh
    from repro_torch.kernels.contingency import ops

    dev = resolve_device(device)
    shard = dataclasses.replace(cell, G=cell.g_loc, A=cell.a_loc, n_data=1, n_model=1)
    started = not dist.is_initialized()
    tmp = tempfile.mkdtemp(prefix="repro_torch_dryrun_") if started else None
    try:
        if started:
            dev = init_process_group(dev, rank=0, world_size=1,
                                     store_path=os.path.join(tmp, "store"))
        if dist.get_world_size() != 1:
            raise RuntimeError("execute_shard runs one rank: the world must have one")
        mesh = make_mesh((1, 1), ("data", "model"), device=dev)
        x, r_ids, d, w, valid = (torch.from_numpy(a).to(dev)
                                 for a in shard_operands(shard, table_dtype=table_dtype))
        n = w.sum().to(torch.float32)
        cand = list(range(shard.A))
        backend = "sweep_xla" if fused_pack else "segment"
        ev = _eval_step(mesh, DELTA, shard.n_bins, shard.M, shard.V, collective,
                        backend=backend)
        adv = _advance_step(mesh, DELTA, shard.n_bins, shard.M, shard.V)
        on_card = dev.type == "cuda"
        sync = torch.cuda.synchronize if on_card else (lambda: None)

        ops.reset_launch_counts()
        counter = _MeshColl.bytes_counter()
        if on_card:
            torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev) if on_card else 0
        sync()
        t0 = time.perf_counter()
        before = counter.value
        theta = ev(cand, r_ids, x, d, w, valid, n)
        sync()
        compile_s = time.perf_counter() - t0
        eval_bytes = counter.value - before
        peak = torch.cuda.max_memory_allocated(dev) - base if on_card else None
        launches = ops.launch_counts()

        a_col = x[:, 0].to(torch.int32)
        before = counter.value
        _new_ids, _k_new, theta_r = adv(a_col, r_ids, d.to(torch.int32), w, valid, n)
        sync()
        adv_bytes = counter.value - before

        # the advance folds candidate 0: its Θ is the solo evaluation's Θ[0]
        solo = _solo_theta(DELTA, x, r_ids, d, w, valid, n, shard)
        got = torch.cat([theta, theta_r.reshape(1)])
        want = torch.cat([solo, solo[:1]])
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        agrees = bool(torch.isfinite(got).all()) and torch.allclose(
            got, want, rtol=1e-5, atol=1e-6 * max(scale, 1e-30))
        out = {"shard": {"granules": shard.G, "candidates": shard.A, "n_bins": shard.n_bins},
               "device": str(dev), "compile_s": compile_s,
               "eval_payload_bytes": eval_bytes, "advance_payload_bytes": adv_bytes,
               "theta_equals_solo": agrees, "max_abs_err": err, "max_abs_solo": scale,
               "launches": launches, "peak_bytes": peak}
        if on_card:
            temps = model_memory(shard, collective, table_dtype=table_dtype,
                                 fused_pack=fused_pack)["temp_bytes"]
            out["peak_over_modelled_temps"] = peak / temps
            out["device_ms"] = _median_ms(torch, lambda: ev(cand, r_ids, x, d, w, valid, n))
            out["advance_ms"] = _median_ms(
                torch, lambda: adv(a_col, r_ids, d.to(torch.int32), w, valid, n))
            out["reps"] = REPS
        return out
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()
        if tmp:
            shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# the LM cells
# ---------------------------------------------------------------------------


def _parse_overrides(pairs):
    out = {}
    for pair in pairs or []:
        k, v = pair.split("=", 1)
        if v in ("True", "False"):
            v = v == "True"
        else:
            try:
                v = int(v)
            except ValueError:
                try:
                    v = float(v)
                except ValueError:
                    pass
        out[k] = v
    return out


@contextlib.contextmanager
def fake_world(shape, axis_names):
    """A fake world of ``prod(shape)`` ranks (this process rank 0, PyTorch's
    ``"fake"`` backend: collectives do nothing) and its mesh, inside
    :func:`repro_torch.device.modelling`; the group is destroyed on exit.
    Refuses to start while a process group is up."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.device import modelling
    from repro_torch.distributed.api import make_mesh

    if dist.is_initialized():
        raise RuntimeError("a process group is already up: the dry-run starts its own fake "
                           "world (run it in a process of its own)")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=int(np.prod(shape)))
    try:
        with modelling():
            yield make_mesh(tuple(shape), tuple(axis_names), device="cuda")
    finally:
        dist.destroy_process_group()


def count_step(fn, args) -> Dict:
    """Run ``fn(*args)`` once under a :class:`~repro_torch.launch.roofline.StepCounter`
    and return its counts and the step's memory (module doc)."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.rwkv6 import ops as rk
    from repro_torch.launch.roofline import StepCounter, storages

    arg = storages(args)
    fa.reset_modelled_counts()
    rk.reset_modelled_counts()
    with StepCounter() as c:
        out = fn(*args)
    res = storages(out)
    held = c.held_bytes(out)
    mem = {"argument_bytes": sum(arg.values()), "output_bytes": sum(res.values()),
           "temp_bytes": c.peak_bytes - held,
           "alias_bytes": sum(n for k, n in res.items() if k in arg)}
    mem["total_hbm_bytes"] = (mem["argument_bytes"] + mem["output_bytes"] + mem["temp_bytes"]
                              - mem["alias_bytes"])
    return {"memory": mem, "flops": c.flops, "bytes": c.bytes,
            "convert_bytes": c.convert_bytes, "collectives": c.collective_stats(),
            "calls": list(c.collectives),
            "kernels": c.kernels, "ops": c.ops,
            "modelled": {**fa.modelled_counts(), **rk.modelled_counts()}}


def _count_cell(cfg, shape, mesh, setup_kw) -> Dict:
    from repro_torch.launch.specs import make_setup

    fn, args, _placements, _donate = make_setup(cfg, shape, mesh, **setup_kw)
    return count_step(fn, args)


def run_cell(arch: str, shape_name: str, mesh_kind: str, *, skip_probes: bool = False,
             setup_kw=None, overrides=None, cfg=None, layout=None, shape=None) -> dict:
    """One LM cell, counted on a fake world of the production mesh's size
    (module doc).  ``skip_probes`` counts the step as configured only
    (memory and ``scanned_cost``), as JAX's skips its probes.  ``cfg``,
    ``layout`` (a :class:`~repro_torch.launch.mesh.MeshLayout`) and
    ``shape`` (a ``ShapeConfig``) override the arch's config, the production
    mesh and the shape (tests)."""
    from repro_torch.configs import get_config, shape_applies
    from repro_torch.launch import roofline as rl
    from repro_torch.models.config import SHAPES

    cfg = cfg or get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shape = shape or SHAPES[shape_name]
    record = {"arch": arch, "shape": shape_name, "mesh": mesh_kind}
    if not shape_applies(cfg, shape):
        record["status"] = "skipped"
        record["reason"] = SKIP_REASON
        return record

    layout = layout or _build_mesh(mesh_kind)
    n_chips = layout.size
    record["chips"] = int(n_chips)
    record["mesh_shape"] = dict(layout.shape)
    record["modelled"] = True
    record["compile_s"] = None
    record["memory_model"] = LM_MEMORY_MODEL
    setup_kw = setup_kw or {}
    t0 = time.time()
    with fake_world(tuple(layout.shape.values()), layout.axis_names) as mesh:
        full = _count_cell(cfg, shape, mesh, setup_kw)
        record["memory_per_device"] = full["memory"]
        record["scanned_cost"] = {"flops_per_device": full["flops"],
                                  "bytes_per_device": full["bytes"]}
        if skip_probes:
            record["count_s"] = round(time.time() - t0, 1)
            record["status"] = "ok"
            return record
        # FLOPs: naive attention (every flop visible); bytes and collectives:
        # the production path; both without remat, as JAX's probe configs
        prod = full if shape.kind != "train" else _count_cell(
            dataclasses.replace(cfg, **PROBE), shape, mesh, setup_kw)
        naive = _count_cell(dataclasses.replace(cfg, **PROBE, attn_naive=True), shape, mesh,
                            setup_kw)
    record["count_s"] = round(time.time() - t0, 1)

    flops, bytes_ = naive["flops"], prod["bytes"]
    colls = prod["collectives"]
    wire_total = colls["total_wire_bytes"]
    record["flops_per_device"] = flops
    record["bytes_per_device"] = bytes_
    record["convert_bytes_per_device"] = prod["convert_bytes"]
    record["collectives"] = dict(colls, total_wire_bytes_per_device=wire_total)
    record["kernels"] = {"modelled_calls": prod["modelled"], "costs": prod["kernels"]}
    record["roofline"] = rl.roofline_terms(flops, bytes_, wire_total, spec=rl.H100_SXM)
    record["roofline_spec"] = rl.H100_SXM.name
    mf = rl.model_flops(cfg, shape)
    record["model_flops_total"] = mf
    record["model_flops_per_device"] = mf / n_chips
    record["useful_flops_ratio"] = (mf / n_chips) / flops if flops else None
    record["status"] = "ok"
    return record


def run_plar_cell(mesh_kind: str, *, collective: str = "all_reduce",
                  table_dtype: str = "int32", fused_pack: bool = False,
                  execute: bool = False, device="cuda",
                  cell: Optional[PlarCell] = None) -> dict:
    """The paper's own workload: one PLAR greedy-loop iteration at SDSS scale
    on the production mesh, modelled per rank (module doc); with
    ``execute=True`` one rank's steps also run at the shard shape.
    ``cell`` overrides the shape (tests)."""
    import torch

    from repro_torch.launch import roofline as rl

    if collective not in COLLECTIVES:
        raise ValueError(f"unknown collective {collective!r} (one of: {', '.join(COLLECTIVES)})")
    if table_dtype not in TABLE_DTYPES:
        raise ValueError(f"unknown table dtype {table_dtype!r} (one of: int32, int8)")
    layout = _build_mesh(mesh_kind)
    cell = cell or PlarCell.production(mesh_kind)
    record = {"arch": "plar-sdss", "shape": "eval_iteration", "mesh": mesh_kind,
              "chips": layout.size, "collective": collective,
              "table_dtype": table_dtype, "fused_pack": fused_pack,
              "mesh_shape": dict(layout.shape),
              "cell": dataclasses.asdict(cell) | {"n_bins": cell.n_bins},
              "shard": [cell.g_loc, cell.a_loc], "modelled": True, "compile_s": None}
    mem = model_memory(cell, collective, table_dtype=table_dtype, fused_pack=fused_pack)
    record["memory_per_device"] = {k: mem[k] for k in ("argument_bytes", "output_bytes",
                                                       "temp_bytes")}
    record["memory_breakdown"] = {"arguments": mem["arguments"], "temps": mem["temps"]}
    record["memory_model"] = MEMORY_MODEL
    cost = model_cost(cell, collective, table_dtype=table_dtype)
    colls = model_eval_collectives(cell, collective)
    record["flops_per_device"] = cost["flops"]
    record["bytes_per_device"] = cost["bytes"]
    record["collectives"] = colls
    on_card = execute and torch.device(device).type == "cuda"
    spec = rl.device_spec(device) if on_card else rl.H100_SXM
    record["roofline"] = rl.roofline_terms(cost["flops"], cost["bytes"],
                                           colls["total_wire_bytes"], dtype="f32", spec=spec)
    record["roofline_spec"] = spec.name
    # "useful work": the contingency scatter-adds — A·G adds of m-sized rows
    record["model_flops_total"] = float(cell.A) * cell.G * 2
    record["advance_collectives"] = model_advance_collectives(cell)
    record["status"] = "ok"
    record["advance_step"] = "ok"
    if execute:
        ran = execute_shard(cell, collective, table_dtype=table_dtype, fused_pack=fused_pack,
                            device=device)
        record["compile_s"] = ran.pop("compile_s")
        record["executed"] = ran
        if not ran["theta_equals_solo"]:
            record["status"] = "error"
            record["reason"] = (f"the shard step's Θ differs from the solo evaluation "
                                f"(max abs err {ran['max_abs_err']})")
    return record


def _run_all(args, meshes) -> None:
    """One subprocess a cell, skipping cells whose JSON exists (JAX's ``--all``)."""
    from repro_torch.configs import cells

    jobs = [(a, s, m) for (a, s) in cells() for m in meshes]
    jobs += [("plar-sdss", "eval_iteration", m) for m in meshes]
    for arch, shape, mesh_kind in jobs:
        path = os.path.join(args.out, f"{arch}__{shape}__{mesh_kind}.json")
        if os.path.exists(path) and not args.force:
            print(f"[skip] {path} exists")
            continue
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--mesh", mesh_kind,
               "--out", args.out]
        cmd += ["--plar"] if arch == "plar-sdss" else ["--arch", arch, "--shape", shape]
        print(f"[run ] {arch} × {shape} × {mesh_kind}", flush=True)
        r = subprocess.run(cmd, capture_output=True, text=True)
        if r.returncode != 0:
            err = {"arch": arch, "shape": shape, "mesh": mesh_kind,
                   "status": "error", "stderr": r.stderr[-4000:]}
            with open(path, "w") as f:
                json.dump(err, f, indent=2)
            print(f"[FAIL] {arch} × {shape} × {mesh_kind}", flush=True)
        else:
            print(r.stdout.strip().splitlines()[-1] if r.stdout.strip() else "", flush=True)


def _finish(record: dict, path: str) -> None:
    with open(path, "w") as f:
        json.dump(record, f, indent=2, default=float)
    rf = record.get("roofline", {})
    print(f"{record['arch']} × {record['shape']} × {record['mesh']}: {record['status']} "
          f"compile={record.get('compile_s')}s dominant={rf.get('dominant')}")
    if record["status"] == "error":
        print(record.get("traceback", record.get("reason", ""))[-2000:], file=sys.stderr)
        sys.exit(1)


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--plar", action="store_true")
    ap.add_argument("--out", default="runs/dryrun")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--tag", default=None, help="suffix for perf-variant records")
    ap.add_argument("--override", action="append", default=[],
                    help="ArchConfig overrides, e.g. --override flash_bwd=True")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--collective", default="all_reduce",
                    choices=["all_reduce", "reduce_scatter"])
    ap.add_argument("--table-dtype", default="int32", choices=["int32", "int8"])
    ap.add_argument("--fused-pack", action="store_true")
    ap.add_argument("--execute", action="store_true",
                    help="also run one rank's PLAR steps at the shard shape on --device")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    os.makedirs(args.out, exist_ok=True)
    if args.all:
        _run_all(args, meshes)
        return {}
    suffix = f"__{args.tag}" if args.tag else ""
    if not args.plar:
        try:
            setup_kw = ({"microbatches": args.microbatches}
                        if args.microbatches > 1 and args.shape == "train_4k" else {})
            record = run_cell(args.arch, args.shape, meshes[0],
                              overrides=_parse_overrides(args.override), setup_kw=setup_kw)
        except Exception:
            record = {"arch": args.arch, "shape": args.shape, "mesh": meshes[0],
                      "status": "error", "traceback": traceback.format_exc()[-4000:]}
        _finish(record, os.path.join(
            args.out, f"{args.arch}__{args.shape}__{meshes[0]}{suffix}.json"))
        return record
    record = {}
    for mesh_kind in meshes:
        try:
            record = run_plar_cell(mesh_kind, collective=args.collective,
                                   table_dtype=args.table_dtype, fused_pack=args.fused_pack,
                                   execute=args.execute, device=args.device)
        except Exception:
            record = {"arch": "plar-sdss", "shape": "eval_iteration", "mesh": mesh_kind,
                      "status": "error", "traceback": traceback.format_exc()[-4000:]}
        _finish(record, os.path.join(
            args.out, f"plar-sdss__eval_iteration__{mesh_kind}{suffix}.json"))
    return record


if __name__ == "__main__":
    main()
