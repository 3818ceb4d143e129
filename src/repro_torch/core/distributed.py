"""Distributed PLAR: the paper's MDP (model + data parallelism) on a mesh of ranks.

The PyTorch port of ``repro.core.distributed``.  Mapping (DESIGN.md §2) —
this *is* the paper's architecture, re-expressed:

    Spark construct                     mesh construct
    -----------------------------------------------------------------
    RDD granule partitions, .cache()    granule tensors sharded over ('pod','data'), device-resident
    MP process pool over candidates     candidate axis sharded over 'model'
    map (re-key onto B∪D)               packed ids  p = r·V + x[:,a]   (local)
    reduceByKey                         per-shard contingency + all-reduce over the data group
    driver sum()                        θ rows summed on-shard (redundantly, post-reduce)
    driver argmax                       host argmin over the gathered [A] thetas, on every rank

JAX drives the mesh from one controller (``shard_map`` over a ``Mesh``, host
reads of sharded arrays).  Here every rank of a ``torch.distributed`` world
runs this same driver on its own shard (SPMD; :mod:`repro_torch.distributed`):

    JAX (single controller)                  port (one rank a mesh position)
    -----------------------------------------------------------------------
    Mesh, mesh.shape[...]                    distributed.api.Mesh: shape, n_data, n_model, groups
    psum over the data axes                  dist.all_reduce over the data group
    all_gather over 'model', tiled           all_gather_into_tensor over the model group
    psum_scatter(scatter_dimension=1)        reduce_scatter_tensor, bins moved to dim 0
    np.asarray(sharded array)                all-gather over the data group, on every rank
    jit(shard_map(while_loop))               the device engine's loop over _MeshColl

Every host decision (the argmin, the stop test, the regrouping plan) reads
only replicated values, so every rank issues the same collectives in the
same order.

Three collective schedules for the contingency merge (the §Perf knob):

* ``all_reduce``      — paper-faithful DP: every data shard sums the full
  ``[nc_loc, K·V, m]`` contingency, then reduces θ locally.
* ``reduce_scatter``  — beyond-paper: each shard reduces θ over its *slice*
  of contingency rows (θ is row-separable, Eq. 8!) and a scalar sum merges.
  Halves collective bytes and distributes the θ flops; exact because
  Θ(D|B) = Σ_i θ(S_i) commutes with row partitioning.
* ``fused``           — beyond-paper (DESIGN.md §5.2): the driver re-shards
  granules between iterations so every *current class* lives on one data
  shard.  Then every packed key ``p = r·V + v`` — for every candidate — is
  shard-local, each contingency row is complete on exactly one shard, and a
  shard's fused contingency→Θ partial (θ of a row absent from the shard is
  exactly 0) sums to the exact Θ[c]: cross-device payload O(nc·K·m) → O(nc).
  The partial is the CUDA fused-Θ kernel's raw output on the card
  (``kernels/contingency/ops.fused_theta_raw``), its plain version on the
  CPU.  Iterations whose class sizes don't pack into the per-shard capacity
  fall back to ``all_reduce``.

Correctness notes:
* Per-shard granularity tables may hold duplicate keys across shards — the
  contingency sum is key-additive, so dedup is never a correctness
  requirement.  The same property licenses *streaming* ingestion
  (``source=``): each shard folds its slice of every chunk through the
  granularity monoid merge (DESIGN.md §3.6).
* Id compaction uses the presence-bitmap/all-reduce construction, so every
  shard agrees on the global dense numbering (DESIGN.md §3.1).
* The attribute core (one-time, paper lines 3–8) is computed on gathered
  granule tables — G ≪ N after GrC init; the greedy hot loop is fully
  distributed.
"""
from __future__ import annotations

import time
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import obs
from repro_torch.device import host_float, host_int, to_host

from . import measures
from .engine import (
    _Bins,
    _MeshColl,
    _advance,
    _mesh_thetas,
    make_engine_run_mesh,
    run_engine,
)
from .granularity import Granularity, build_granularity, fold_chunk, next_pow2, with_capacity
from .plan import (
    MESH_BACKENDS,
    _masked_w,
    check_backend,
    check_engine,
    check_selector,
    ladder_rungs,
    rung_for,
    subset_ids,
    theta_for_ids,
)
from .reduction import (
    ReductionResult,
    _check_source_args,
    _core_inner_thetas,
    _counted_span,
    _materialize,
)

__all__ = ["plar_reduce_distributed", "partition_rows"]


def _host(a, dtype):
    """A numpy array of ``a`` (numpy, list or tensor on any device)."""
    if isinstance(a, torch.Tensor):
        a = a.cpu().numpy()
    return np.asarray(a, dtype)


# ---------------------------------------------------------------------------
# sharded evaluation / advance steps
# ---------------------------------------------------------------------------


def _eval_step(mesh, delta: str, n_bins: int, m: int, v_max: int, collective: str, *,
               backend: str = "segment", selector: Optional[str] = None):
    """This rank's step: candidates over 'model' × granules over data → thetas.

    Returns ``step(cand, r_ids, x, d, w, valid, n) -> [a_pad]`` where
    ``cand`` is the whole padded candidate list (a multiple of the model
    shard count; model shard i evaluates slice i) and the result is every
    shard's Θ gathered over 'model', the same on every rank.  The
    ``all_reduce`` and ``reduce_scatter`` schedules are the device engine's
    (``engine._mesh_thetas``, ``backend`` segment or sweep_xla); ``fused``
    is this loop's own.  ``n_bins`` may be any §5.3 ladder rung ≥ K·V.
    ``selector`` picks the fused kernel's launch shape on each rank's own
    shard shape; no collective depends on it.
    """
    coll = _MeshColl(mesh)
    nm = mesh.n_model

    def step(cand, r_ids, x, d, w, valid, n):
        a_loc = len(cand) // nm
        cols = torch.as_tensor(np.asarray(cand[coll.model_index * a_loc:
                                               (coll.model_index + 1) * a_loc], np.int64),
                               device=x.device)
        x_cand = x.index_select(1, cols).t().to(torch.int32)      # [A_loc, G_loc]
        if collective == "fused":
            # Per-shard fused contingency→Θ partial + scalar sum.  Exact only
            # under the driver's class-grouped placement (module docstring):
            # rows this shard doesn't own are all-zero and contribute θ' = 0.
            # Raw partials are summed *before* the single normalization so
            # Θ_PR stays integer-exact across shard counts.
            from repro_torch.kernels.contingency.ops import fused_theta_raw

            packed = (r_ids[None, :] * v_max + x_cand).contiguous()
            raw = fused_theta_raw(packed, d.to(torch.int32), _masked_w(w, valid),
                                  delta=delta, n_bins=n_bins, n_dec=m, selector=selector)
            th = measures.theta_scale(delta, coll.psum_data(raw), n)
        else:
            th = _mesh_thetas(delta, x_cand, r_ids, d, w, valid, n, coll, collective,
                              n_bins=n_bins, m=m, v_max=v_max, backend=backend)
        return coll.gather_model(th, len(cand))

    return step


def _advance_step(mesh, delta: str, n_bins: int, m: int, v_max: int):
    """Fold the winning attribute into the shared reduction state.

    The pack → presence all-reduce → rank → contingency body is the engine's
    ``_advance`` with the mesh collective adapter — one copy of the
    shard-consistent compaction logic (DESIGN.md §3.1) for both drivers.
    Returns ``step(a_col, r_ids, d, w, valid, n) -> (new_ids, k_new, theta)``.
    """
    coll = _MeshColl(mesh)
    bins = _Bins(n_bins, v_max, m)

    def step(a_col, r_ids, d, w, valid, n):
        new_ids, k_new, theta, _g_pure = _advance(bins, coll, r_ids, a_col, d, w, valid, n, delta)
        return new_ids, k_new, theta

    return step


# The device engine evaluates every body at its top rung, cap·V bins (cap the
# mesh's whole granule capacity: the per-shard capacity × n_data, which GrC
# on a row-partitioned table leaves at the shard's row count), so a body's
# candidate contingency is [A_loc, cap·V, m] f32 whatever K is; the
# measures' temporaries, the reduce_scatter's bin-major copy and the graph's
# pool take several more of that size (chip_smoke.py phase 9 on an H100:
# segment/SCE peaked at 32.3 GB beside a 4.9 GB contingency).
ENGINE_WORKSET_FACTOR = 8


def _device_budget_bytes(dev: torch.device) -> Optional[int]:
    """What the device engine may take on ``dev``: the card's free memory
    and what PyTorch's allocator holds unused.  ``None`` on the CPU, where
    ``auto`` keeps JAX's rule."""
    if dev.type != "cuda":
        return None
    free, _total = torch.cuda.mem_get_info(dev)
    return int(free + torch.cuda.memory_reserved(dev) - torch.cuda.memory_allocated(dev))


def _resolve_engine(engine: str, collective: str, mesh, a_loc: int, cap: int, v_max: int,
                    m: int) -> str:
    """JAX's ``auto`` rule (``host`` for ``fused``, else ``device``), except
    that ``auto`` takes the host loop where the device engine's static
    working set (:data:`ENGINE_WORKSET_FACTOR` contingencies of ``[a_loc,
    cap·V, m]`` f32) exceeds the smallest budget over the world's ranks, so
    every rank picks the same engine.  ``cap`` is the mesh's whole granule
    capacity, the per-shard capacity × ``n_data``: on an x, d table (whole or
    handed over as partitions) GrC keeps each shard's table at its padded
    row count, so ``cap`` is the table's rows rounded up to ``n_data``
    shards (5,000,000 at kdd99: ~1.5 TB of working set, the host loop)."""
    if engine != "auto":
        return engine
    if collective == "fused":
        return "host"
    budget = _device_budget_bytes(mesh.device)
    if budget is None:
        return "device"
    least = torch.tensor([budget], dtype=torch.int64, device=mesh.device)
    dist.all_reduce(least, op=dist.ReduceOp.MIN)
    need = ENGINE_WORKSET_FACTOR * a_loc * cap * v_max * m * 4
    return "device" if need <= int(least) else "host"


# ---------------------------------------------------------------------------
# distributed GrC build
# ---------------------------------------------------------------------------


def partition_rows(n_rows: int, mesh):
    """The rows ``[lo, hi)`` of an ``n_rows`` table that this rank's data
    shard holds: contiguous blocks of ``ceil(n_rows / n_data)`` rows, the
    last one short (the HDFS load).  A whole table handed to
    :func:`plar_reduce_distributed` is split so."""
    cps = -(-n_rows // mesh.n_data)
    lo = min(mesh.data_index * cps, n_rows)
    return lo, min(lo + cps, n_rows)


def _agree_partition(x, d, mesh, n_dec: Optional[int], v_max: Optional[int]):
    """This rank's own rows ``x [n_loc, A], d`` as a shard of the whole
    table, on the mesh's device: ``(x, d, valid, n_rows, n_dec, v_max)``,
    padded to the largest shard's row count.  One all-reduce (max) over the
    data group agrees on every shard's row count and, where not given, on
    ``n_dec`` and ``v_max``; no row leaves its card."""
    dev, nd = mesh.device, mesh.n_data
    x = x.to(dev, torch.int32)
    d = d.to(dev, torch.int32)
    n_loc = x.shape[0]
    agreed = torch.zeros((nd + 2,), dtype=torch.int64, device=dev)
    agreed[mesh.data_index] = n_loc
    if n_loc:
        if n_dec is None:
            agreed[nd] = d.max() + 1
        if v_max is None:
            agreed[nd + 1] = x.max() + 1
    if mesh.data_axes:
        _MeshColl._count(agreed)
        dist.all_reduce(agreed, op=dist.ReduceOp.MAX, group=mesh.data_group)
    h = to_host(agreed).numpy()
    cps = int(h[:nd].max())
    if n_loc < cps:
        x = torch.cat([x, x.new_zeros((cps - n_loc, x.shape[1]))])
        d = torch.cat([d, d.new_zeros((cps - n_loc,))])
    valid = torch.arange(cps, device=dev) < n_loc
    return (x, d, valid, int(h[:nd].sum()), int(h[nd]) if n_dec is None else n_dec,
            int(h[nd + 1]) if v_max is None else v_max)


def _gather_ints(mesh, values) -> np.ndarray:
    """One small int64 vector from every data shard, ``[nd, len(values)]``,
    the same on every rank."""
    t = torch.tensor(values, dtype=torch.int64, device=mesh.device)
    return to_host(_MeshColl(mesh).gather_data(t).reshape(-1, len(values))).numpy()


def _granularity_from_source(source, mesh, *, n_dec: int, v_max: int, chunk_rows: int):
    """Distributed GrC init without the sharded full table resident.

    Each data shard folds its slice of every chunk through the streaming
    monoid merge, so peak host memory is O(chunk + per-shard granularity
    capacity) instead of the full ``(n_rows, n_attrs)`` array that an x, d
    call holds.  Every rank
    materializes each chunk once and keeps its slice (the ``TokenStream.shard``
    partition).  Cross-shard duplicate keys are allowed — the contingency sum
    is key-additive (module docstring) — so shards granulate independently,
    exactly like the per-partition combiner of a Spark reduceByKey.
    """
    nd, s = mesh.n_data, mesh.data_index
    acc = None
    for i in range(source.n_chunks(chunk_rows)):
        xc, dc = source.chunk(i, chunk_rows)
        n = xc.shape[0]
        lo, hi = s * n // nd, (s + 1) * n // nd
        acc = fold_chunk(acc, xc[lo:hi], dc[lo:hi], n_dec=n_dec, v_max=v_max,
                         device=mesh.device)
    mine = [-1, 0] if acc is None else [int(acc.num), int(acc.n_total)]
    per_shard = _gather_ints(mesh, mine)
    if (per_shard[:, 0] < 0).any():
        raise ValueError("source yielded no rows for at least one data shard")
    cap_ps = max(next_pow2(max(int(num), 16)) for num in per_shard[:, 0])
    g = with_capacity(acc, cap_ps).to(mesh.device)
    return g.x, g.d, g.w, g.valid, int(per_shard[:, 1].sum())


def _granularity_to_mesh(gran: Granularity, mesh):
    """Split a prebuilt granularity contiguously over the data shards.

    Live granules are distinct keys, so any row partition of them is a valid
    per-shard granularity table; capacities pad to a common power of two.
    """
    nd, s = mesh.n_data, mesh.data_index
    live = int(gran.num)
    cap_ps = next_pow2(max(-(-max(live, 1) // nd), 16))
    lo, hi = s * live // nd, (s + 1) * live // nd
    g = gran.to(mesh.device)
    w = g.w[lo:hi]
    shard = Granularity(
        x=g.x[lo:hi], d=g.d[lo:hi], w=w, valid=g.valid[lo:hi],
        num=torch.tensor(hi - lo, dtype=torch.int32, device=mesh.device),
        n_total=w.sum().to(torch.int32),
        n_attrs=gran.n_attrs, n_dec=gran.n_dec, v_max=gran.v_max,
    )
    g = with_capacity(shard, cap_ps).to(mesh.device)
    return g.x, g.d, g.w, g.valid, int(gran.n_total)


# ---------------------------------------------------------------------------
# class-grouped placement for the fused schedule
# ---------------------------------------------------------------------------


def _regroup_by_class(gx, gd, gw, gvalid, r_ids, mesh):
    """Re-shard granules so each current class id lives on one data shard.

    The precondition of the ``fused`` collective (module docstring).  Classes
    are packed onto shards least-loaded-first (LPT) with the JAX package's
    numpy calls, on every rank alike; returns this rank's re-placed tensors,
    or ``None`` when some shard would overflow its static capacity — the
    caller then falls back to ``all_reduce`` for that iteration.
    Feasibility is decided from ``r_ids``/``valid`` alone (an O(G)
    all-gather); the O(G·A) granule table is gathered only when packing
    succeeds.  The Spark analogue is a ``partitionBy`` on the cached RDD, and
    G ≪ N after GrC init.  (A ragged all-to-all keyed on the class id would
    move each granule once instead of gathering the table.)
    """
    nd = mesh.n_data
    if nd == 1:
        # One data shard: class grouping holds trivially, nothing to move.
        return gx, gd, gw, gvalid, r_ids
    coll = _MeshColl(mesh)
    cps = gx.shape[0]
    vh = to_host(coll.gather_data(gvalid.to(torch.int32))).numpy().astype(bool)
    rh = to_host(coll.gather_data(r_ids)).numpy()
    live = np.nonzero(vh)[0]
    classes, inverse, counts = np.unique(
        rh[live], return_inverse=True, return_counts=True)

    loads = np.zeros(nd, np.int64)
    assign = np.empty(len(classes), np.int64)
    for ci in np.argsort(-counts):
        s = int(np.argmin(loads))
        if loads[s] + counts[ci] > cps:
            return None
        assign[ci] = s
        loads[s] += counts[ci]

    xh = to_host(coll.gather_data(gx)).numpy()
    dh = to_host(coll.gather_data(gd)).numpy()
    wh = to_host(coll.gather_data(gw)).numpy()
    rows = live[assign[inverse] == mesh.data_index]
    nx = np.zeros((cps,) + xh.shape[1:], xh.dtype)
    nd_ = np.zeros((cps,), dh.dtype)
    nw = np.zeros((cps,), wh.dtype)
    nv = np.zeros((cps,), bool)
    nr = np.zeros((cps,), rh.dtype)
    sl = slice(0, len(rows))
    nx[sl], nd_[sl], nw[sl], nr[sl] = xh[rows], dh[rows], wh[rows], rh[rows]
    nv[sl] = True
    dev = mesh.device
    return tuple(torch.from_numpy(a).to(dev) for a in (nx, nd_, nw, nv, nr))


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------


def plar_reduce_distributed(
    x=None,
    d=None,
    mesh=None,
    *,
    partition: bool = False,            # x, d: this rank's own rows, on mesh.device
    source=None,                        # Granularity | GranuleSource (alt. to x, d)
    chunk_rows: int = 65536,            # streaming-ingestion chunk size
    delta: str = "PR",
    n_dec: Optional[int] = None,
    v_max: Optional[int] = None,
    eps: float = 0.0,
    tol: float = 1e-6,
    tie_tol: float = 1e-5,
    max_features: Optional[int] = None,
    collective: str = "all_reduce",     # | "reduce_scatter" | "fused" (§Perf)
    backend: str = "segment",           # | "sweep_xla" (read-once slab, §5.3)
    ladder: bool = False,               # K-adaptive bin ladder (§5.3)
    selector: str = "analytic",         # tile/rung selection mode
    compute_core: bool = True,
    grc_init: bool = True,
    engine: str = "auto",               # "device" loop | "host" loop
) -> ReductionResult:
    """PLAR Algorithm 2 on a ('pod','data','model') mesh.  See module doc.

    Every rank of the mesh's world calls this with the same arguments (the
    whole table, or the same source) and gets the same result; ``mesh``
    (:func:`repro_torch.distributed.api.make_mesh`) names this rank's
    device and groups.  With ``partition=True`` each rank instead hands
    over its data shard's own rows ``x, d``, already on ``mesh.device``, as a
    deployment caches its partitions there (the ranks of one model group
    hand over the same rows): no table goes through the host and no rank
    copies another's rows.  One small all-reduce agrees on the row count
    and the per-shard capacity (a whole table is split by
    :func:`partition_rows` and takes the same path, so rows handed over as
    it splits them give the whole table's result bit for bit).  The
    result's ``granules`` is this rank's granule table.
    """
    t0 = time.perf_counter()
    if collective not in ("all_reduce", "reduce_scatter", "fused"):
        raise ValueError(
            f"unknown collective: {collective!r} "
            "(one of: all_reduce, reduce_scatter, fused)")
    check_backend(backend, MESH_BACKENDS, "mesh ")
    check_engine(engine)
    check_selector(selector, "selector")
    if engine == "device" and collective == "fused":
        raise ValueError(
            "engine='device' cannot run the 'fused' collective: its class "
            "regrouping stages granules through the host between iterations; "
            "use engine='host'")
    if collective == "fused" and backend != "segment":
        raise ValueError(
            "collective='fused' has its own fused contingency→Θ schedule; "
            "backend must stay 'segment'")
    if mesh is None:
        raise ValueError("mesh is required")
    _check_source_args(x, d, source)
    if partition and source is not None:
        raise ValueError("partition=True takes this rank's rows as x, d, not a source")
    nd, nm = mesh.n_data, mesh.n_model
    coll = _MeshColl(mesh)
    dev = mesh.device

    if source is not None:
        # declared source metadata is authoritative on every ingestion path
        # (never re-inferred from whichever classes/values happened to
        # realize) — both Granularity and GranuleSource carry these fields
        n_dec = source.n_dec if n_dec is None else n_dec
        v_max = source.v_max if v_max is None else v_max

    if source is not None and not isinstance(source, Granularity) and not grc_init:
        # HAR cost model (every raw row a granule) has nothing to stream
        # into — materialize, same thin adapter as resolve_granularity.
        x, d = _materialize(source, chunk_rows)
        source = None

    # --- GrC initialization (distributed, cached in device memory) ---
    if isinstance(source, Granularity):
        A = source.n_attrs
        gx, gd, gw, gvalid, n_rows = _granularity_to_mesh(source, mesh)
    elif source is not None:
        A, n_rows = source.n_attrs, source.n_rows
        gx, gd, gw, gvalid, _ = _granularity_from_source(
            source, mesh, n_dec=n_dec, v_max=v_max, chunk_rows=chunk_rows)
    else:
        with _counted_span("mesh.granulate") as sp:
            if not partition:               # the whole table: keep this shard's rows
                x, d = _host(x, np.int32), _host(d, np.int32)
                lo, hi = partition_rows(x.shape[0], mesh)
                x, d = torch.from_numpy(x[lo:hi]), torch.from_numpy(d[lo:hi])
            xs, ds, vs, n_rows, n_dec, v_max = _agree_partition(x, d, mesh, n_dec, v_max)
            A = xs.shape[1]
            if grc_init:
                # per-shard GrC (paper lines 1–2), no cross-shard dedup:
                # duplicate keys across shards are weight-additive (module doc)
                g = build_granularity(xs, ds, n_dec=n_dec, v_max=v_max, valid=vs, exact=True,
                                      capacity=xs.shape[0])
                gx, gd, gw, gvalid, num = g.x, g.d, g.w, g.valid, g.num
            else:
                gx, gd, gvalid = xs, ds, vs
                gw = torch.ones((xs.shape[0],), dtype=torch.int32, device=dev)
                num = vs.sum()
            sp.set(rows=int(x.shape[0]), granules=host_int(num))
    n = torch.tensor(float(n_rows), dtype=torch.float32, device=dev)

    cap_loc = gx.shape[0]
    cap = nd * cap_loc

    # --- Θ(D|C) (stop target) + core, on gathered granules (one-time) ---
    with _counted_span("mesh.core", n_attrs=A, n_data=nd) as sp:
        gv_h = coll.gather_data(gvalid.to(torch.int32)).to(torch.bool)
        gran_h = Granularity(
            x=coll.gather_data(gx), d=coll.gather_data(gd), w=coll.gather_data(gw), valid=gv_h,
            num=gv_h.sum().to(torch.int32),
            n_total=torch.tensor(n_rows, dtype=torch.int32, device=dev),
            n_attrs=A, n_dec=n_dec, v_max=v_max,
        )
        gathered = sum(t.numel() * t.element_size()
                       for t in (gran_h.x, gran_h.d, gran_h.w)) + cap * 4
        ids_c, _ = subset_ids(gran_h, list(range(A)), exact=True)
        theta_full = host_float(theta_for_ids(delta, ids_c, gran_h, n_bins=cap))

        core: List[int] = []
        n_evals = 0
        if compute_core:
            inner = _core_inner_thetas(gran_h, delta, exact=True)
            core = [int(a) for a in range(A) if inner[a] - theta_full > eps + tie_tol]
            n_evals += A
        del gran_h, ids_c
        sp.set(gathered_bytes=gathered, core=len(core))

    engine = _resolve_engine(engine, collective, mesh, -(-A // nm), cap, v_max, n_dec)
    if engine == "device":
        # One loop on every rank runs the whole reduction on the device: the
        # single-process engine's body over the mesh collective adapter, with
        # no host round-trip between iterations but the ``done`` poll.  The
        # ``fused`` collective never gets here: its class regrouping moves
        # granule tables between ranks between iterations (module docstring).
        max_sel = int(max_features) if max_features is not None else A
        runner = make_engine_run_mesh(
            mesh, collective, delta, backend, A, cap, n_dec, v_max, float(tol),
            float(tie_tol), max_sel, bool(ladder), str(selector))
        reduct, theta_hist, iterations, ev, per_iter_s = run_engine(
            runner, cap_loc, A, gvalid, gx, gd, gw, n_rows, theta_full, core)
        n_evals += ev
    else:
        # --- distributed greedy loop state (engine == "host") ---
        r_ids = torch.zeros((cap_loc,), dtype=torch.int32, device=dev)
        k = 1
        reduct: List[int] = []
        theta_hist: List[float] = []
        per_iter_s: List[float] = []

        # Same (cap, m)-only rung set as the single-process drivers — the mesh
        # host loop lands on the identical rung set (§5.3 byte parity).
        rungs = ladder_rungs(cap * v_max, selector=selector, g=cap, m=n_dec)

        def adv_bins_for(k_):
            # The advance bound is ladder-independent (the §5.3 ladder shrinks
            # only the candidate evaluation), so theta histories are identical
            # with the ladder on or off.
            return next_pow2(max(k_, 1)) * v_max

        def bins_for(k_):
            # Candidate-eval bound.  Ladder on: snap to the §5.3 rungs — every
            # rung is divisible by the (pow2) data-shard count, so
            # reduce_scatter keeps tiling at every K.  Ladder off: the legacy
            # pow2(k)·V bound.
            if ladder:
                return rung_for(k_, v_max, rungs)
            return adv_bins_for(k_)

        def fold(a):
            nonlocal r_ids, k
            adv = _advance_step(mesh, delta, adv_bins_for(k), n_dec, v_max)
            r_ids, k_new, theta = adv(gx[:, a], r_ids, gd, gw, gvalid, n)
            k = host_int(k_new)
            reduct.append(a)
            theta_hist.append(host_float(theta))
            return theta_hist[-1]

        iterations = 0
        # f32-mirrored stop threshold: same iteration count as the device cond
        stop_thresh = measures.f32_threshold(theta_full, tol)
        # The loop's collective bytes (the core's folds and every iteration's
        # merge, regrouping and advance; not the one-time gathers of the core
        # and Θ(D|C) above).
        nbytes = _MeshColl.bytes_counter()
        bytes_before = nbytes.value
        with _counted_span("mesh.loop", collective=collective, n_attrs=A, cap=cap) as sp:
            for a in core:
                fold(a)
            theta_r = theta_hist[-1] if theta_hist else float("inf")
            remaining = [a for a in range(A) if a not in reduct]
            while remaining and theta_r > stop_thresh:
                if max_features is not None and len(reduct) >= max_features:
                    break
                it0 = time.perf_counter()
                it_bytes = nbytes.value
                n_bins = bins_for(k)
                # candidate axis padded to the model-shard multiple (the MP level)
                a_pad = -(-len(remaining) // nm) * nm
                cand = np.full((a_pad,), remaining[-1], np.int64)
                cand[: len(remaining)] = remaining

                iter_collective = collective
                with obs.span("mesh.iteration", i=iterations, candidates=len(remaining),
                              n_bins=n_bins) as sp_it:
                    # regrouping (fused), the merge and the advance, to the
                    # fold's read of Θ(D|R)
                    if collective == "fused":
                        regrouped = _regroup_by_class(gx, gd, gw, gvalid, r_ids, mesh)
                        if regrouped is None:
                            # Classes too large to pack (early iterations) — K is
                            # small then, so the all_reduce payload O(nc·K·m) is
                            # still cheap.
                            iter_collective = "all_reduce"
                            obs.counter("plar_mesh_fused_fallbacks_total",
                                        "fused-schedule iterations run as all_reduce").inc()
                        else:
                            gx, gd, gw, gvalid, r_ids = regrouped
                            obs.counter("plar_mesh_fused_iterations_total",
                                        "iterations of the fused schedule").inc()

                    ev = _eval_step(mesh, delta, n_bins, n_dec, v_max, iter_collective,
                                    backend=backend, selector=selector)
                    thetas = to_host(ev(cand, r_ids, gx, gd, gw, gvalid, n)).numpy()
                    thetas = thetas.astype(np.float64)[: len(remaining)]
                    n_evals += len(remaining)

                    theta_r = fold(remaining.pop(measures.argmin_with_ties(thetas, tie_tol)))
                    sp_it.set(collective=iter_collective, bytes=nbytes.value - it_bytes)
                iterations += 1
                per_iter_s.append(time.perf_counter() - it0)
            sp.set(iterations=iterations, collective_bytes=nbytes.value - bytes_before)

    return ReductionResult(
        reduct=reduct,
        core=core,
        theta_full=theta_full,
        theta_history=theta_hist,
        iterations=iterations,
        n_evaluations=n_evals,
        elapsed_s=time.perf_counter() - t0,
        per_iteration_s=per_iter_s,
        granules=Granularity(x=gx, d=gd, w=gw, valid=gvalid, num=gvalid.sum().to(torch.int32),
                             n_total=torch.tensor(n_rows, dtype=torch.int32, device=dev),
                             n_attrs=A, n_dec=n_dec, v_max=v_max),
    )
