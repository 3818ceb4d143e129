"""Analytic cost model of the Hopper contingency kernels (the port's
counterpart of ``repro.kernels.contingency.model``).

The JAX package models its TPU kernels as one-hot matmuls over a
``(bc, bk, bg)`` grid under a VMEM budget.  The CUDA kernels here work
otherwise, so the terms are derived again for them:

* ``contingency`` (``csrc/contingency.cu``): one pass of grid-strided
  threads, an atomic add a live (c, g) pair, after the wrapper's zero fill
  of ``[nc, n_bins, m]``.
* ``fused`` (``csrc/fused_theta.cu``) and ``sweep`` (``csrc/sweep_theta.cu``):
  the keys are sorted into 256-bin tile segments (count, plan and scatter
  passes), each tile's histogram is built in shared memory (one warp for a
  short segment, a CTA of 256 threads a chunk of a long one), the θ'
  epilogue runs on it, and the per-tile partials are summed in ascending
  order (``csrc/segments.cuh``).

Every launch is a sequence of passes (:class:`Pass`): its CTAs and their
threads, shared memory and registers, the device-memory bytes it moves, the
SM cycles of its work, and a serial chain no parallelism shortens.  A pass's
modeled time (:func:`pass_time_s`) is a fixed launch cost, a start-up cost a
wave, the serial chain, and the larger of:

* issue: the busiest SM's share of the cycles (``ceil(ctas / sms)`` CTAs),
  at full rate only with enough of its thread slots resident to hide
  latency (``Costs.issue_fill``; ``long_fill`` for the long tiles, whose
  shared-memory atomics need more);
* memory: the bytes over the device-memory rate, reached only with enough
  of the card's thread slots resident (``Costs.mem_fill``), stretched by
  the same imbalance.

CTAs resident per SM come from shared memory (against the SM's total, each
block paying the runtime's reserve), registers (``nvcc -Xptxas -v``, by
warp, in units of 256) and threads.  A tiling is feasible when each pass
fits a block: shared memory within the opt-in limit, at most 1,024 threads,
one CTA resident.  Work is counted where the kernels do it: a count or
scatter warp's atomics are its distinct buckets; a short-tile warp takes a
(segment, bc candidates) item at a time, in whole rounds of the grid's
warps; a long-tile CTA zeroes and reads back ``bc`` histograms, loads each
entry once and gathers and adds it for each candidate of its block.

Where the work depends on the data (which tiles are short, long or split)
the model assumes keys spread evenly over the bin tiles, as a table whose
class count tracks the bin bound gives; a table whose keys crowd into few
tiles at a large bound (the first greedy iteration without the ladder) is
not its input.  The rates (:class:`Costs`) are fitted to measured tilings
on the card; ``chip_smoke.py`` phase 16 prints the modeled time beside the
measured one.

The tiling of each kernel (:data:`TILE_FIELDS`) changes the launch shape
only; the 256-bin tile (``plan.LADDER_TILE``) is not a field.
"""
from __future__ import annotations

import dataclasses
import math
from functools import lru_cache
from typing import Dict, Iterable, Optional, Sequence, Tuple

from repro_torch.cards import H100_SXM, DeviceSpec

__all__ = [
    "KernelCost",
    "Pass",
    "contingency_cost",
    "fused_cost",
    "sweep_cost",
    "kernel_cost",
    "modeled_time_s",
    "pass_time_s",
    "resident_ctas",
    "feasible_tiles",
    "rank_tiles",
    "select_tiles",
    "prune_ladder_rungs",
    "rung_eval_cost_bytes",
    "KERNELS",
    "TILE_FIELDS",
    "PINNED_TILES",
    "LADDER_MIN_SAVING",
]

KERNELS = ("contingency", "fused", "sweep")
# The fields of each kernel's tiling, in order:
# * threads / ctas: a CTA's threads, and the grid's cap in CTAs an SM;
# * chunk: the fewest keys of a long segment's chunk (one CTA's work);
# * bc: the candidates a segment entry is read for at once (sweep only: a
#   fused segment is one candidate's).
TILE_FIELDS: Dict[str, Tuple[str, ...]] = {
    "contingency": ("threads", "ctas"),
    "fused": ("chunk", "threads"),
    "sweep": ("bc", "chunk", "threads"),
}
# The launch shapes the kernels had fixed before they took a tiling (selector
# "pinned").
PINNED_TILES: Dict[str, Tuple[int, ...]] = {
    "contingency": (256, 64),
    "fused": (4096, 256),
    "sweep": (4, 4096, 256),
}

# Candidate values the analytic selector searches.
CANDIDATE_THREADS = (128, 256, 512, 1024)
CANDIDATE_CTAS = (1, 2, 4, 8, 16, 32, 64)
CANDIDATE_CHUNK = (1024, 2048, 4096, 8192, 16384)
CANDIDATE_BC = (1, 2, 4, 8)

TILE = 256              # bins a Θ tile (plan.LADDER_TILE): not a field
SHORT_MAX = 32          # entries of a short segment, one a lane
SHORT_THREADS = 256
SHORT_SMEM = SHORT_THREADS // 32 * (TILE + 4 * 32) * 4   # static shared memory a short CTA
LONG_THREADS = TILE     # one thread a bin row in the dense epilogue
PLAN_THREADS = 1024
FUSED_MAX_CHUNKS = 512  # fused_theta.cu kMaxChunks
SWEEP_MAX_SPLIT = 64    # sweep_theta.cu kMaxSplit

CLOCK_HZ = 1.98e9       # H100 SXM's top SM clock: SM cycles to seconds


@dataclasses.dataclass(frozen=True)
class Costs:
    """The model's rates: seconds of fixed costs, shares of an SM's thread
    slots, and SM cycles a unit of work.

    The values are fitted (``python -m repro_torch.launch.fit_tiles``) to
    every feasible tiling's device time at kdd99's uniform shapes on an
    NVIDIA H100 80GB HBM3 at 700 W (``python -m
    repro_torch.launch.time_tiles``), but for the plan's and the ordered
    sum's serial chains, read off one call's kernels (``python -m
    repro_torch.launch.profile_sweep``).
    """

    launch_s: float = 4.47e-6       # a launch's fixed cost on the stream
    wave_s: float = 1.07e-6         # a wave's start-up and its last loads' latency
    mem_fill: float = 0.485         # share of the thread slots that keeps memory busy
    issue_fill: float = 0.247       # share of an SM's thread slots that hides latency
    long_fill: float = 0.77         # the same for the long tiles' shared-memory atomics
    plan_round_s: float = 3.6e-6    # one round of a plan CTA: a block scan and its atomics
    sum_add_s: float = 4.7e-9       # one tile of the ordered sum: its staging and dependent add
    cont_pair: float = 3.64         # contingency: a (c, g) pair's 64-bit div/mod, loads, atomic
    flat_key: float = 0.468         # count pass: a key or granule
    flat_atomic: float = 1.78       # count pass: a warp's atomic add for one bucket
    scatter_key: float = 1.55       # scatter pass: a key or granule, its write
    scatter_atomic: float = 4.08    # scatter pass: a warp's cursor atomic for one bucket
    short_item: float = 4.28        # short tile: load an entry, restore the row values
    short_cand: float = 86.0        # short tile, a candidate: the matches, the row, the tile sum
    cell: float = 0.0555            # a shared-memory histogram cell zeroed, flushed or merged
    long_entry: float = 0.549       # long tile: an entry loaded, a candidate block
    long_cand: float = 0.42         # long tile: an entry's gather and atomic, a candidate


COSTS = Costs()

# registers a thread, by pass and (segment kernels) by bc: nvcc -Xptxas -v for
# sm_90a, the largest over the four measures
REGS = {"flat": 25, "plan": 46, "sum": 24, "contingency": 22}
REGS_SHORT = {1: 31, 2: 37, 4: 37, 8: 40}
REGS_LONG = {1: 40, 2: 48, 4: 59, 8: 71}

# Ladder pruning keeps a smaller rung only if it saves at least this share of
# the next kept rung's modeled eval traffic (the JAX package's constant).
LADDER_MIN_SAVING = 0.15


def _cdiv(a: float, b: float) -> int:
    return int(-(-a // b))


def _round_up(v: int, mult: int) -> int:
    return _cdiv(v, mult) * mult


@dataclasses.dataclass(frozen=True)
class Pass:
    """One launch of a kernel's sequence, as the model sees it."""

    name: str
    ctas: int
    threads: int
    smem: int = 0            # shared memory a CTA, bytes
    regs: int = 32           # registers a thread
    hbm_bytes: float = 0.0   # device-memory traffic
    flops: float = 0.0       # f32 operations
    cycles: float = 0.0      # SM cycles of work, spread evenly over the CTAs
    serial_s: float = 0.0    # a dependent chain no parallelism shortens
    long: bool = False       # the long tiles: their atomics need more resident threads


@dataclasses.dataclass(frozen=True)
class KernelCost:
    """Closed-form cost of one wrapper call: its passes, in order.

    ``transcendentals`` counts the epilogue's logarithms (0 for the
    contingency and for Θ_PR).
    """

    passes: Tuple[Pass, ...]
    transcendentals: float = 0.0

    @property
    def flops(self) -> float:
        return sum(p.flops for p in self.passes)

    @property
    def hbm_bytes(self) -> float:
        return sum(p.hbm_bytes for p in self.passes)

    @property
    def smem_bytes(self) -> int:
        """The largest shared memory a CTA of any pass takes."""
        return max((p.smem for p in self.passes), default=0)

    @property
    def launches(self) -> int:
        return len(self.passes)


def resident_ctas(threads: int, smem: int, regs: int, spec: DeviceSpec = H100_SXM) -> int:
    """CTAs of this shape an SM holds at once; 0 when one does not fit."""
    if threads < 1 or threads > spec.threads_per_block or smem > spec.smem_per_block:
        return 0
    warps = _cdiv(threads, 32)
    regs_per_warp = _round_up(regs * 32, 256)
    return min(spec.blocks_per_sm,
               spec.threads_per_sm // threads,
               spec.smem_per_sm // (smem + spec.smem_reserved_per_block),
               spec.regs_per_sm // (warps * regs_per_warp))


def pass_time_s(p: Pass, spec: DeviceSpec = H100_SXM, costs: Costs = COSTS) -> float:
    """Modeled seconds of one pass (module doc); inf when a CTA does not fit.

    The busiest SM holds ``ceil(ctas / sms)`` CTAs, as many at once as
    fit; its share of the cycles, at the issue rate its resident threads
    sustain, bounds the pass, and so do the bytes, at the memory rate the
    card's resident threads sustain, stretched by the same imbalance.
    """
    if p.ctas <= 0:
        return costs.launch_s + p.serial_s
    r = resident_ctas(p.threads, p.smem, p.regs, spec)
    if r < 1:
        return math.inf
    n_max = _cdiv(p.ctas, spec.sms)
    share = n_max / p.ctas                    # of the work, on the busiest SM
    occ = min(n_max, r) * p.threads / spec.threads_per_sm
    fill = min(p.ctas, spec.sms * r) * p.threads / (spec.sms * spec.threads_per_sm)
    issue_fill = costs.long_fill if p.long else costs.issue_fill
    busy = p.cycles * share / (CLOCK_HZ * min(1.0, occ / issue_fill))
    imbalance = n_max * spec.sms / p.ctas if p.ctas >= spec.sms else 1.0
    memory = p.hbm_bytes * imbalance / (spec.hbm_bytes_per_s * min(1.0, fill / costs.mem_fill))
    compute = p.flops / spec.f32_ops_per_s
    return (costs.launch_s + _cdiv(n_max, r) * costs.wave_s + max(memory, busy, compute)
            + p.serial_s)


def modeled_time_s(cost: KernelCost, spec: DeviceSpec = H100_SXM, costs: Costs = COSTS) -> float:
    """The call's modeled seconds: its passes' times summed."""
    return sum(pass_time_s(p, spec, costs) for p in cost.passes)


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------


def _fill(name: str, nbytes: float) -> Pass:
    """A zero fill (``cudaMemsetAsync``, ``torch.zeros``): 16 bytes a thread,
    four stores a thread."""
    return Pass(name, ctas=max(_cdiv(nbytes, 16 * 4 * 256), 1), threads=256, hbm_bytes=nbytes)


def contingency_cost(nc: int, g: int, n_bins: int, m: int, threads: int, ctas: int,
                     spec: DeviceSpec = H100_SXM, costs: Costs = COSTS) -> KernelCost:
    """The zero fill of ``[nc, n_bins, m]`` and the atomic pass."""
    pairs = nc * g
    out = 4.0 * nc * n_bins * m
    fill = _fill("zero_fill", out)
    grid = max(min(_cdiv(pairs, threads), spec.sms * ctas), 1) if pairs else 0
    # an add lands in L2; past L2 its 32-byte sector is read and written back
    atomics = pairs * (64.0 if out > spec.l2_bytes else 0.0)
    main = Pass("contingency", ctas=grid, threads=threads, regs=REGS["contingency"],
                hbm_bytes=4.0 * pairs + 8.0 * g + atomics, flops=float(pairs),
                cycles=pairs * costs.cont_pair)
    return KernelCost((fill, main))


def _atomics_per_warp(buckets: int) -> float:
    """Distinct buckets among a warp's 32 keys, spread evenly over
    ``buckets``: the count and scatter passes' atomics a warp."""
    return buckets * (1.0 - (1.0 - 1.0 / max(buckets, 1)) ** 32)


def _segments(reads: float, n_segs: int, chunk: int):
    """(short segments, long chunks, split segments, entries in long ones)
    when ``reads`` entries spread evenly over ``n_segs`` segments."""
    if n_segs <= 0 or reads <= 0:
        return 0.0, 0, 0, 0.0
    avg = reads / n_segs
    if avg <= SHORT_MAX:
        return n_segs * (1.0 - math.exp(-avg)), 0, 0, 0.0
    per = _cdiv(avg, chunk)
    return 0.0, n_segs * per, (n_segs if per > 1 else 0), float(reads)


def _segment_passes(*, nc: int, seg_cands: int, n_tiles: int, m: int, bc: int, inst: int,
                    n_cb: int, short: float, long_items: int, long_cap: int,
                    long_entries: float, x_gather_bytes: float, spec: DeviceSpec,
                    costs: Costs) -> Tuple[Pass, ...]:
    """The short tiles, the long tiles and the ordered sum (segments.cuh);
    ``seg_cands`` candidates read each segment (the sweep's nc, the fused
    kernel's one), ``bc`` at once through the kernels' ``inst`` instance."""
    regs_short, regs_long = REGS_SHORT[inst], REGS_LONG[inst]
    short_per_sm = resident_ctas(SHORT_THREADS, SHORT_SMEM, regs_short, spec)
    short_ctas = max(min(_cdiv(short * n_cb, SHORT_THREADS // 32),
                         spec.sms * max(short_per_sm, 1)), 1)
    # a warp takes an item (a segment, bc candidates) at a time: the work is
    # whole rounds of the grid's warps
    warps = short_ctas * (SHORT_THREADS // 32)
    rounds = _cdiv(short * n_cb, warps) if short else 0
    short_p = Pass(
        "short_tiles", ctas=short_ctas, threads=SHORT_THREADS, smem=SHORT_SMEM, regs=regs_short,
        hbm_bytes=x_gather_bytes * (short > 0) + 4.0 * nc * n_tiles,
        cycles=rounds * warps * (costs.short_item + min(bc, seg_cands) * costs.short_cand))
    long_smem = bc * (TILE * m + TILE) * 4
    long_per_sm = resident_ctas(LONG_THREADS, long_smem, regs_long, spec)
    long_p = Pass(
        "long_tiles", ctas=max(min(long_cap * n_cb, spec.sms * max(long_per_sm, 1)), 1)
        if long_items else 0,
        threads=LONG_THREADS, smem=long_smem, regs=regs_long, long=True,
        hbm_bytes=x_gather_bytes * (long_items > 0),
        cycles=(long_items * n_cb * bc * (TILE * m + TILE) * costs.cell
                + long_entries * (n_cb * costs.long_entry + seg_cands * costs.long_cand)))
    sum_p = Pass("ordered_sum", ctas=nc, threads=256, regs=REGS["sum"],
                 hbm_bytes=4.0 * nc * n_tiles, serial_s=n_tiles * costs.sum_add_s)
    return short_p, long_p, sum_p


def fused_cost(nc: int, g: int, n_bins: int, m: int, chunk: int, threads: int,
               delta: str = "SCE", spec: DeviceSpec = H100_SXM,
               costs: Costs = COSTS) -> KernelCost:
    """One fused-Θ call: per-candidate tile segments, then segments.cuh."""
    n_tiles = _cdiv(max(n_bins, 1), TILE)
    reads = nc * g
    buckets = nc * n_tiles
    chunk_eff = max(chunk, _round_up(_cdiv(reads, FUSED_MAX_CHUNKS), TILE))
    shared = n_tiles * 4 <= 48 * 1024
    ctas = spec.sms * (1024 // threads)
    flat = max(_cdiv(reads, ctas), 4 * threads, n_tiles if shared else 0)
    flat = max(min(_round_up(flat, threads), _round_up(g, threads)), threads)
    grid = _cdiv(g, flat) * nc if g else 0
    short, long_items, split, long_entries = _segments(reads, buckets, chunk_eff)
    memset = _fill("memset", 8.0 * nc * (n_tiles + 1))
    count = Pass("count", ctas=grid, threads=threads, smem=n_tiles * 4 if shared else 0,
                 regs=REGS["flat"], hbm_bytes=4.0 * reads + 8.0 * g,
                 cycles=reads * costs.flat_key
                 + reads / 32 * _atomics_per_warp(n_tiles) * costs.flat_atomic
                 + (grid * n_tiles * costs.cell if shared else 0))
    plan = Pass("plan", ctas=nc, threads=PLAN_THREADS, regs=REGS["plan"],
                hbm_bytes=12.0 * buckets + 16.0 * (short + long_items),
                serial_s=2 * _cdiv(n_tiles, 4 * PLAN_THREADS) * costs.plan_round_s)
    scatter = Pass("scatter", ctas=grid, threads=threads, regs=REGS["flat"],
                   hbm_bytes=8.0 * reads + 8.0 * g + 4.0 * split * TILE * m,
                   cycles=reads * costs.scatter_key
                   + reads / 32 * _atomics_per_warp(n_tiles) * costs.scatter_atomic)
    long_cap = _cdiv(reads, chunk_eff) + min(buckets, _cdiv(reads, SHORT_MAX + 1)) + 1
    segs = _segment_passes(nc=nc, seg_cands=1, n_tiles=n_tiles, m=m, bc=1, inst=4, n_cb=1,
                           short=short, long_items=long_items, long_cap=long_cap,
                           long_entries=long_entries, x_gather_bytes=0.0, spec=spec,
                           costs=costs)
    trans = 0.0 if delta == "PR" else float(min(reads, nc * n_bins * m))
    return KernelCost((memset, count, plan, scatter) + segs, trans)


def sweep_cost(nc: int, g: int, n_bins: int, m: int, bc: int, chunk: int, threads: int,
               v_max: int = 1, delta: str = "SCE", spec: DeviceSpec = H100_SXM,
               costs: Costs = COSTS) -> KernelCost:
    """One sweep-Θ call: class-ordered granule segments, then segments.cuh.

    The shared ``r_ids``/``d``/``w`` are read once a call; a segment entry
    (16 bytes, from L2) once a block of ``bc`` candidates, so the per-entry
    work carries a 1/bc factor, against ``bc`` histograms a long CTA zeroes,
    holds in shared memory and reads back.
    """
    n_tiles = _cdiv(max(n_bins, 1), TILE)
    s_span = _cdiv(max(v_max, 1), TILE)
    # a class straddles two tiles with probability (V - 1)/256 (V <= 256)
    reads = g * (1.0 + (v_max - 1) / TILE) if v_max <= TILE else g * (s_span + 1.0)
    chunk_eff = max(chunk, _round_up(_cdiv((s_span + 1) * g, SWEEP_MAX_SPLIT), TILE))
    per_cand = (TILE * m + TILE) * 4
    bc_eff = max(min(bc, nc, spec.smem_per_block // per_cand), 1)
    n_cb = _cdiv(nc, bc_eff)
    grid = max(min(_cdiv(g, threads), spec.sms * (2048 // threads)), 1)
    short, long_items, split, long_entries = _segments(reads, n_tiles, chunk_eff)
    memset = _fill("memset", 4.0 * (2 * n_tiles + 1))
    atomics = g / 32 * _atomics_per_warp(2 * n_tiles)
    count = Pass("count", ctas=grid, threads=threads, regs=REGS["flat"], hbm_bytes=12.0 * g,
                 cycles=g * costs.flat_key + atomics * costs.flat_atomic)
    plan = Pass("plan", ctas=1, threads=PLAN_THREADS, regs=REGS["plan"],
                hbm_bytes=24.0 * n_tiles + 16.0 * (short + long_items),
                serial_s=(_cdiv(2 * n_tiles, 4 * PLAN_THREADS)
                          + _cdiv(n_tiles, 4 * PLAN_THREADS)) * costs.plan_round_s)
    scatter = Pass("scatter", ctas=grid, threads=threads, regs=REGS["flat"],
                   hbm_bytes=28.0 * g + 4.0 * split * n_cb * bc_eff * TILE * m,
                   cycles=g * costs.scatter_key + atomics * costs.scatter_atomic)
    # the slab x_t is gathered from L2 once it is read, while it fits there
    x_bytes = 4.0 * nc * g
    x_gather = x_bytes if x_bytes <= spec.l2_bytes else 32.0 * nc * reads
    long_cap = min(n_tiles + _cdiv((s_span + 1) * g, chunk_eff) + 1,
                   _cdiv((s_span + 1) * g, SHORT_MAX + 1) + _cdiv((s_span + 1) * g, chunk_eff) + 1)
    segs = _segment_passes(nc=nc, seg_cands=nc, n_tiles=n_tiles, m=m, bc=bc_eff, inst=bc,
                           n_cb=n_cb, short=short, long_items=long_items, long_cap=long_cap,
                           long_entries=long_entries, x_gather_bytes=x_gather, spec=spec,
                           costs=costs)
    trans = 0.0 if delta == "PR" else float(min(nc * reads, nc * n_bins * m))
    return KernelCost((memset, count, plan, scatter) + segs, trans)


def kernel_cost(kernel: str, nc: int, g: int, n_bins: int, m: int, tiles: Sequence[int], *,
                v_max: int = 1, delta: str = "SCE", spec: DeviceSpec = H100_SXM,
                costs: Costs = COSTS) -> KernelCost:
    """Dispatch by kernel name; ``tiles`` in the order of :data:`TILE_FIELDS`."""
    tiles = tuple(int(t) for t in tiles)
    if kernel not in TILE_FIELDS:
        raise ValueError(f"unknown kernel: {kernel!r} (one of: {', '.join(KERNELS)})")
    if len(tiles) != len(TILE_FIELDS[kernel]):
        raise ValueError(f"{kernel} tiles are {TILE_FIELDS[kernel]}, got {tiles}")
    if kernel == "contingency":
        return contingency_cost(nc, g, n_bins, m, *tiles, spec=spec, costs=costs)
    if kernel == "fused":
        return fused_cost(nc, g, n_bins, m, *tiles, delta=delta, spec=spec, costs=costs)
    return sweep_cost(nc, g, n_bins, m, *tiles, v_max=v_max, delta=delta, spec=spec,
                      costs=costs)


def feasible_tiles(kernel: str, nc: int, g: int, n_bins: int, m: int, *,
                   spec: DeviceSpec = H100_SXM) -> Tuple[Tuple[int, ...], ...]:
    """The candidate tilings whose every pass fits a block of ``spec``.

    A grid cap (``ctas``) at least twice what the pairs need launches the
    same grid as the next smaller one, and a candidate block (``bc``) at
    least twice ``nc`` holds only padding: neither is a candidate.  When no
    candidate fits (a 256-bin histogram of ``m`` decisions past shared
    memory) the result is the pinned tiling alone, which the kernel then
    refuses with its own error.
    """
    if kernel not in TILE_FIELDS:
        raise ValueError(f"unknown kernel: {kernel!r} (one of: {', '.join(KERNELS)})")
    out = []
    if kernel == "contingency":
        for threads in CANDIDATE_THREADS:
            want = max(_cdiv(nc * g, threads), 1)
            for ctas in CANDIDATE_CTAS:
                if ctas == 1 or spec.sms * (ctas // 2) < want:
                    out.append((threads, ctas))
    else:
        per_cand = (TILE * m + TILE) * 4
        bcs = [bc for bc in CANDIDATE_BC
               if bc // 2 < max(nc, 1) and bc * per_cand <= spec.smem_per_block]
        if kernel == "fused":
            bcs = [1] if bcs else []
        for bc in bcs:
            for chunk in CANDIDATE_CHUNK:
                for threads in CANDIDATE_THREADS:
                    tiles = (chunk, threads) if kernel == "fused" else (bc, chunk, threads)
                    cost = kernel_cost(kernel, nc, g, n_bins, m, tiles, spec=spec)
                    if all(resident_ctas(p.threads, p.smem, p.regs, spec) >= 1
                           for p in cost.passes if p.ctas > 0):
                        out.append(tiles)
    return tuple(out) or (PINNED_TILES[kernel],)


def _distance_from_pinned(kernel: str, tiles: Tuple[int, ...]) -> float:
    return sum(abs(math.log2(t / p)) for t, p in zip(tiles, PINNED_TILES[kernel]))


def rank_tiles(kernel: str, nc: int, g: int, n_bins: int, m: int, *,
               v_max: int = 1, delta: str = "SCE",
               candidates: Optional[Iterable[Sequence[int]]] = None,
               spec: DeviceSpec = H100_SXM
               ) -> Tuple[Tuple[Tuple[int, ...], KernelCost, float], ...]:
    """Candidates sorted by modeled time, ``((tiles, cost, time_s), ...)``.

    Ties go to the tiling nearest the pinned one (the sum of each
    field's |log2| ratio to it), then to the smaller tuple, so the rank is a
    pure function of the shape and the spec.
    """
    if candidates is None:
        cands = feasible_tiles(kernel, nc, g, n_bins, m, spec=spec)
    else:
        cands = tuple(tuple(int(t) for t in c) for c in candidates)
    scored = []
    for tiles in cands:
        cost = kernel_cost(kernel, nc, g, n_bins, m, tiles, v_max=v_max, delta=delta, spec=spec)
        scored.append((tiles, cost, modeled_time_s(cost, spec)))
    scored.sort(key=lambda s: (s[2], _distance_from_pinned(kernel, s[0]), s[0]))
    return tuple(scored)


@lru_cache(maxsize=4096)
def _select(kernel, nc, g, n_bins, m, v_max, delta, spec):
    return rank_tiles(kernel, nc, g, n_bins, m, v_max=v_max, delta=delta, spec=spec)[0][0]


def select_tiles(kernel: str, nc: int, g: int, n_bins: int, m: int, *,
                 v_max: int = 1, delta: str = "SCE", spec: DeviceSpec = H100_SXM
                 ) -> Tuple[int, ...]:
    """The analytic selector: the best modeled tiling for the shape (memoized:
    the host loop asks once an iteration)."""
    return _select(kernel, int(nc), int(g), int(n_bins), int(m), int(v_max),
                   "PR" if delta == "PR" else "SCE", spec)


# ---------------------------------------------------------------------------
# ladder-rung pruning (plan.ladder_rungs selector="analytic", DESIGN.md §5.3)
# ---------------------------------------------------------------------------


def rung_eval_cost_bytes(rung: int, g: int, m: int) -> float:
    """Modeled per-candidate eval traffic at bin bound ``rung``: a term paid
    at every rung (the candidate's slab row, ``r_ids`` and ``w``/``d``,
    ``4·G·(2 + m)``) plus a bin-proportional one (the ``[rung, m]`` counts
    written and read, ``8·rung·m``).

    The JAX package's function, kept as it is so that the pruned ladder is
    JAX's exactly: a function of ``(G, m)`` only, so host loop, device engine
    and mesh driver derive the same rung set (DESIGN.md §5.3).  Rungs change
    speed, never bits.
    """
    fixed = 4.0 * g * (2 + m)
    per_bin = 2.0 * 4.0 * rung * m
    return fixed + per_bin


def prune_ladder_rungs(rungs: Sequence[int], g: int, m: int, *,
                       min_saving: float = LADDER_MIN_SAVING) -> Tuple[int, ...]:
    """Drop rungs whose modeled eval saving is below ``min_saving``.

    Walks down from the (always kept) exact top rung and keeps a rung only
    if it cuts the modeled eval cost of the last kept rung by at least
    ``min_saving``.  The result is a subset of the input closed over the top
    rung, so every §5.3 invariant is inherited and results are
    byte-identical to the unpruned ladder.
    """
    rungs = tuple(rungs)
    if len(rungs) <= 1:
        return rungs
    kept = [rungs[-1]]
    for r in reversed(rungs[:-1]):
        if (rung_eval_cost_bytes(r, g, m)
                <= (1.0 - min_saving) * rung_eval_cost_bytes(kept[-1], g, m)):
            kept.append(r)
    return tuple(sorted(kept))
