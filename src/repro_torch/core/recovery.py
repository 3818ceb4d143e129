"""Shard lineage + re-fold recovery: the RDD resilience story done natively.

The paper's PLAR framework gets fault tolerance for free from Spark: a lost
RDD partition is *recomputed from its lineage* — the recorded chain of
deterministic transformations that produced it — instead of restarting the
job (arXiv 1610.01807 §IV).  This module is the native equivalent for the
GrC granularity build (DESIGN.md §3.10):

* :class:`ShardLineage` records, per data shard, exactly which
  ``GranuleSource`` chunk ranges folded into it.  Because a conforming
  source is a pure function of ``(seed, step)`` (data/pipeline.py), the
  lineage is a complete recipe: no raw rows need to be retained.
* :func:`build_sharded` is the lineage-recording twin of the JAX mesh
  driver's per-shard streaming fold (``repro/core/distributed.py``, not yet
  ported): chunk ``i`` is sliced
  ``[s·n/S, (s+1)·n/S)`` per shard and folded through the §3.6 monoid
  merge, and the slice bounds are recorded as the shard's lineage.
* :func:`refold_shard` replays ONE shard's lineage — the same
  ``fold_chunk`` calls on the same rows, the same ops on the same shapes —
  so the recovered shard granularity is **bitwise identical** to the lost
  one, and re-merging it with the survivors reproduces the unfailed merged
  granularity (and therefore byte-identical downstream reducts and Θ
  histories; tests/test_torch_recovery.py).

Recovery cost model: a shard death costs ``O(rows/S)`` re-fold work plus
one (S-way) re-merge, versus ``O(rows)`` for a from-scratch rebuild.

The port's ``repro.core.recovery``, on the port's ``fold_chunk`` /
``merge_granularity``: the folds run on ``device`` (default ``cuda``), which
:func:`build_sharded` and :func:`refold_shard` take and pass down to every
``fold_chunk``.  The lineage records no device: a shard may re-fold on
another device, and the replay is the same bits (tests/test_torch_recovery.py
holds the port's build, re-fold and merge against the JAX package's).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch import obs
from repro_torch.device import DeviceLike, resolve_device

from .granularity import (
    Granularity,
    fold_chunk,
    merge_granularity,
    next_pow2,
    with_capacity,
)

__all__ = [
    "ChunkSlice",
    "ShardLineage",
    "ShardedBuild",
    "build_sharded",
    "refold_shard",
    "merge_shards",
    "recover",
]


@dataclasses.dataclass(frozen=True)
class ChunkSlice:
    """Rows ``[lo, hi)`` of ``source.chunk(step, chunk_rows)``."""

    step: int
    lo: int
    hi: int


@dataclasses.dataclass(frozen=True)
class ShardLineage:
    """The complete, replayable recipe for one data shard's granularity.

    ``slices`` lists the chunk ranges (in fold order) that produced the
    shard; the remaining fields pin the fold's static knobs so a replay
    executes the *same* builds.  Serializes to plain
    JSON (:meth:`to_dict`) so checkpoints can persist it as metadata.
    """

    shard_index: int
    n_shards: int
    chunk_rows: int
    n_dec: int
    v_max: int
    exact: bool
    slices: Tuple[ChunkSlice, ...]

    def to_dict(self) -> dict:
        return {
            "shard_index": self.shard_index,
            "n_shards": self.n_shards,
            "chunk_rows": self.chunk_rows,
            "n_dec": self.n_dec,
            "v_max": self.v_max,
            "exact": self.exact,
            "slices": [[s.step, s.lo, s.hi] for s in self.slices],
        }

    @classmethod
    def from_dict(cls, d: dict) -> "ShardLineage":
        return cls(
            shard_index=int(d["shard_index"]),
            n_shards=int(d["n_shards"]),
            chunk_rows=int(d["chunk_rows"]),
            n_dec=int(d["n_dec"]),
            v_max=int(d["v_max"]),
            exact=bool(d["exact"]),
            slices=tuple(ChunkSlice(int(a), int(b), int(c))
                         for a, b, c in d["slices"]),
        )


@dataclasses.dataclass
class ShardedBuild:
    """A lineage-tracked sharded granularity build.

    ``shards[s]`` is shard ``s``'s granularity (``None`` marks a *lost*
    shard — dropped by a fault); ``lineages[s]`` is its replay recipe;
    ``merged`` is the global granularity (the reduction input).
    """

    shards: List[Optional[Granularity]]
    lineages: List[ShardLineage]
    merged: Granularity

    @property
    def n_shards(self) -> int:
        return len(self.lineages)

    @property
    def lost(self) -> List[int]:
        return [s for s, g in enumerate(self.shards) if g is None]

    def drop(self, shard_index: int) -> None:
        """Simulate shard loss (a died host / evicted device buffer)."""
        if not 0 <= shard_index < len(self.shards):
            raise ValueError(
                f"shard {shard_index} out of range [0, {len(self.shards)})")
        self.shards[shard_index] = None


def _shrink(g: Granularity) -> Granularity:
    """The reduction drivers' capacity policy (next_pow2 of live, floor 16)
    so a merged-from-shards granularity lands on the same static shapes —
    and therefore the same engine compile — as any other build path."""
    return with_capacity(g, next_pow2(max(int(g.num), 16)))


def build_sharded(source, n_shards: int, *, chunk_rows: int = 65536,
                  exact: bool = True, fault_plan=None,
                  device: DeviceLike = "cuda") -> ShardedBuild:
    """Streaming sharded GrC build with lineage recording.

    Mirrors the JAX mesh driver's fold exactly (chunks iterate on the outside,
    shard ``s`` folds rows ``[s·n/S, (s+1)·n/S)`` of every chunk), but each
    shard additionally records its :class:`ChunkSlice` list.  A
    ``fault_plan`` with ``shard_drop`` faults drops the indicated shard
    *after* the fold — the moment a real host would die holding its
    granularity — leaving its lineage behind for :func:`recover`.
    """
    if n_shards < 1:
        raise ValueError(f"n_shards must be ≥ 1, got {n_shards}")
    dev = resolve_device(device)
    accs: List[Optional[Granularity]] = [None] * n_shards
    slices: List[List[ChunkSlice]] = [[] for _ in range(n_shards)]
    with obs.span("recovery.build_sharded", n_shards=n_shards,
                  chunks=source.n_chunks(chunk_rows)):
        _build_folds(source, n_shards, chunk_rows, exact, accs, slices, dev)
    if any(g is None for g in accs):
        raise ValueError("source yielded no rows for at least one data shard")
    lineages = [
        ShardLineage(shard_index=s, n_shards=n_shards, chunk_rows=chunk_rows,
                     n_dec=source.n_dec, v_max=source.v_max, exact=exact,
                     slices=tuple(slices[s]))
        for s in range(n_shards)
    ]
    merged = merge_shards(accs, exact=exact)
    build = ShardedBuild(shards=accs, lineages=lineages, merged=merged)
    if fault_plan is not None:
        spec = fault_plan.fire("shard_drop")
        if spec is not None:
            build.drop(spec.arg if spec.arg is not None else 0)
    return build


def _build_folds(source, n_shards: int, chunk_rows: int, exact: bool,
                 accs: List[Optional[Granularity]],
                 slices: List[List[ChunkSlice]], device) -> None:
    for i in range(source.n_chunks(chunk_rows)):
        xc, dc = source.chunk(i, chunk_rows)
        n = xc.shape[0]
        for s in range(n_shards):
            lo, hi = s * n // n_shards, (s + 1) * n // n_shards
            if hi > lo:
                slices[s].append(ChunkSlice(i, lo, hi))
                accs[s] = fold_chunk(accs[s], xc[lo:hi], dc[lo:hi],
                                     n_dec=source.n_dec, v_max=source.v_max,
                                     exact=exact, device=device)


def refold_shard(source, lineage: ShardLineage, *,
                 device: DeviceLike = "cuda") -> Granularity:
    """Replay one shard's lineage: re-fold exactly the recorded chunk
    ranges on ``device``.  Pure-``(seed, step)`` sources re-materialize the
    same rows, the fold runs the same ops on the same shapes, so the result
    is bitwise identical to the lost shard's granularity."""
    dev = resolve_device(device)
    acc: Optional[Granularity] = None
    with obs.span("recovery.refold_shard", shard=lineage.shard_index,
                  slices=len(lineage.slices)):
        for sl in lineage.slices:
            xc, dc = source.chunk(sl.step, lineage.chunk_rows)
            acc = fold_chunk(acc, xc[sl.lo:sl.hi], dc[sl.lo:sl.hi],
                             n_dec=lineage.n_dec, v_max=lineage.v_max,
                             exact=lineage.exact, device=dev)
    obs.counter("plar_recovery_refolds_total",
                "shard lineages replayed by refold_shard").inc()
    if acc is None:
        raise ValueError(
            f"shard {lineage.shard_index} lineage is empty — nothing to refold")
    return acc


def merge_shards(shards: Sequence[Granularity], *,
                 exact: bool = True) -> Granularity:
    """Fold the per-shard granularities into the global one (left fold of
    the §3.6 monoid merge) and land on the drivers' capacity policy.  The
    merge's final re-sort makes the live prefix the globally sorted
    distinct-key table — independent of how rows were sharded — so the
    result is element-wise identical to a monolithic build's live prefix."""
    if not shards or any(g is None for g in shards):
        raise ValueError("merge_shards requires every shard present "
                         "(recover lost shards first)")
    acc = shards[0]
    for g in shards[1:]:
        acc = merge_granularity(acc, g, exact=exact)
    return _shrink(acc)


def recover(build: ShardedBuild, source, *, fault_plan=None) -> List[int]:
    """Rebuild every lost shard from its lineage and re-merge, in place.

    The re-folds run on the device of the build's merged granularity.
    Returns the list of recovered shard indices.  Only the lost shards are
    re-folded — survivors are reused as-is — so recovery costs
    ``O(lost_rows + merge)``, not a full rebuild.  The recovered ``merged``
    granularity is bitwise identical to the unfailed build's (the refold is
    a deterministic replay; asserted in tests/test_torch_recovery.py), so every
    downstream reduct and Θ history is byte-identical too.

    A ``fault_plan`` with further ``shard_drop`` faults can kill a shard
    *during* recovery (the re-folded replacement is dropped as it lands);
    the loop re-checks and re-folds until no shard is lost, so cascading
    failures converge as long as the plan is finite.
    """
    recovered: List[int] = []
    dev = build.merged.device
    with obs.span("recovery.recover", lost=len(build.lost)) as sp:
        while build.lost:
            for s in list(build.lost):
                g = refold_shard(source, build.lineages[s], device=dev)
                build.shards[s] = g
                recovered.append(s)
                if fault_plan is not None:
                    spec = fault_plan.fire("shard_drop")
                    if spec is not None:
                        build.drop(spec.arg if spec.arg is not None else s)
        build.merged = merge_shards(build.shards,
                                    exact=build.lineages[0].exact)
        sp.set(recovered=len(recovered))
    obs.counter("plar_recovery_recovers_total",
                "recover() calls that re-merged a sharded build").inc()
    return recovered
