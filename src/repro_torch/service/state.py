"""Online reduct state: a live, updatable granularity and its reducts.

The paper's GrC representation is explicitly a *cacheable* compressed form
of the decision table, and its build is a monoid fold.  This module is
the stateful consequence (DESIGN.md §3.7): a :class:`DatasetHandle` keeps a
device-resident :class:`~repro.core.granularity.Granularity` alive across
row-batch updates (``update`` = one ``merge_granularity`` fold, O(new rows),
pow2 capacity growth so engine compiles stay stable) and repairs its reducts
incrementally instead of recomputing them from scratch:

* **resume (optimistic)** — ``plar_reduce(warm_start=prev)`` folds the
  previous reduct through the engine's compiled while_loop
  (:func:`~repro.core.engine.init_state_from_reduct` +
  :func:`~repro.core.engine.engine_resume`) and continues greedy from
  there: prefix attributes cost one fold each — no candidate sweeps — and
  their re-recorded Θ-history entries double as the validation record;
* **validate + trim** — :func:`valid_prefix_len` keeps the longest prefix
  whose every attribute still strictly improves Θ (and cuts at the
  stopping target: anything after is redundant);
* **retry** — only when the prefix was trimmed does the reduction re-run
  from ``prev[:k]``; on stable streams the optimistic pass is final.

Repair is a heuristic with a hard guarantee: the result is always a valid
super-reduct (the greedy stopping rule re-checks Θ against the *current*
Θ(D|C)), but the prefix is kept on significance, not re-checked for
argmin-optimality — re-checking would cost exactly a full recompute.  On
incrementally grown tables the greedy prefix is stable and the repaired
reduct matches the from-scratch one (asserted end-to-end in
tests/test_torch_service.py).

The port's ``repro.service.state``.  A handle carries its device (its
granularity's; ``create``/``create_sharded`` take ``device="cuda"``), and
every reduction runs there.  Device work a handle does off the dispatch
thread — builds, merges, fingerprints, shard recovery — holds the device's
guard shared, and its reductions hold the guard's dispatch lock, so none of
it runs during an engine capture and no two dispatches share a runner's
buffers at once (``core/guard.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.granularity import Granularity, fold_chunk, row_fingerprints
from repro_torch.core.guard import device_guard
from repro_torch.core.measures import f32_threshold
from repro_torch.core.recovery import ShardLineage, ShardedBuild, build_sharded, recover
from repro_torch.core.reduction import (
    ReductionResult,
    expand_ensemble_grid,
    plar_reduce,
    plar_reduce_ensemble,
    resolve_granularity,
)

from repro_torch.device import DeviceLike, resolve_device, to_host

from .errors import ShardLost

__all__ = [
    "DatasetHandle",
    "granularity_fingerprint",
    "valid_prefix_len",
    "repair_reduce",
    "repair_reduce_many",
]

# Seeds for the content fingerprint — distinct from the GrC build seeds
# (0 / 7919) so the fingerprint is independent of the sort bucketing.
_FP_SEED_1 = 104_729
_FP_SEED_2 = 1_299_709
_MASK32 = 0xFFFFFFFF


def _fp_sums(x, d, w, valid):
    """Two uint32 content sums over live granules (order-invariant), as the
    JAX package's wrap-around ``uint32`` sums.

    ``row_fingerprints`` gives int64 tensors holding uint32 values; their
    int64 sum is exact below 2³¹ granules (each term < 2³²), and masking it
    to 32 bits is the uint32 sum with wrap-around, bit for bit.  Integer
    sums are exact in any order, so the card and the CPU agree too.
    """
    key = torch.cat([x, d[:, None].to(x.dtype), w[:, None].to(x.dtype)], dim=1)
    zero = torch.zeros((), dtype=torch.int64, device=x.device)
    sums = torch.stack([torch.where(valid, row_fingerprints(key, seed), zero).sum()
                        for seed in (_FP_SEED_1, _FP_SEED_2)]) & _MASK32
    s1, s2 = (int(v) for v in to_host(sums))
    return s1, s2


def granularity_fingerprint(gran: Granularity) -> int:
    """64-bit content fingerprint of a granularity (the cache key half).

    Hash of the *live* ``(row, d, w)`` multiset: summing per-granule
    fingerprints makes it invariant to slot order and padding capacity, so
    a streamed build and a monolithic build of the same rows fingerprint
    identically (tests/test_torch_service.py::test_fingerprint_content_invariance),
    and the port's fingerprint equals the JAX package's on the same rows (it
    keys the result cache and is checked on checkpoint restore).  Reuses the
    linear row-fingerprint machinery of the GrC build with service-private
    seeds.
    """
    with obs.span("service.fingerprint"):
        s1, s2 = _fp_sums(gran.x, gran.d, gran.w, gran.valid)
    return (s1 << 32) | s2


def valid_prefix_len(theta_history: Sequence[float], theta_full: float, *,
                     tol: float = 1e-6, tie_tol: float = 1e-5) -> int:
    """Longest still-valid prefix given its re-recorded Θ history.

    ``theta_history[i]`` must be Θ(D|prefix[:i+1]) on the *current*
    granularity (what :func:`~repro.core.engine.init_state_from_reduct`
    records).  An attribute stays valid while it still strictly improves Θ
    beyond the tie tolerance — the same band ``argmin_with_ties`` treats as
    indistinguishable; an attribute whose fold no longer clears it would not
    be picked by any greedy iteration.  The prefix is also cut right after
    Θ first reaches the stopping target (``f32_threshold(theta_full, tol)``,
    the engine's own f32 stopping arithmetic): later attributes are
    redundant, so updates can *shrink* a reduct, not only extend it.
    """
    stop = f32_threshold(theta_full, tol)
    prev = float("inf")
    k = 0
    for t in theta_history:
        t = float(t)
        if prev - t <= tie_tol:
            break
        k += 1
        prev = t
        if t <= stop:
            break
    return k


def repair_reduce(gran: Granularity, prev_reduct: Sequence[int], *,
                  delta: str = "PR", **params) -> Tuple[ReductionResult, int]:
    """Validate-and-repair: warm-start a reduction from a previous reduct.

    Returns ``(result, prefix_kept)``.  Optimistic single pass: resume
    greedy directly from the full previous reduct — one driver call whose
    first ``len(prev)`` Θ-history entries (the forced folds, no candidate
    sweeps) double as the validation record.  Only when
    :func:`valid_prefix_len` finds a stale prefix attribute (no longer
    improving Θ, or past an already-reached stopping target) does the
    reduction re-run once from the trimmed prefix; on stable streams the
    common case is exactly one engine seed + resume and one Θ(D|C)
    evaluation.

    Adversarial previous reducts (a stale or corrupt checkpoint, §3.10) are
    sanitized rather than handed to the engine: attributes outside
    ``[0, n_attrs)`` and duplicates are dropped from the warm-start prefix
    (first occurrence wins).  The result is still a valid reduct — the
    warm start is only a hint; validation and the stopping rule run against
    the *current* granularity either way.

    Runs on the granularity's device unless ``params`` names another.
    Span ``service.repair``: ``prev`` (the prefix handed to the warm start),
    ``kept``, ``reruns`` (1 where the trimmed prefix ran again).
    """
    params = {"device": gran.device, **params}
    seen: set = set()
    prev = [int(a) for a in prev_reduct
            if 0 <= int(a) < gran.n_attrs
            and not (int(a) in seen or seen.add(int(a)))]
    with obs.span("service.repair", prev=len(prev)) as sp:
        if not prev:
            sp.set(kept=0, reruns=0)
            return plar_reduce(source=gran, delta=delta, **params), 0

        tol = float(params.get("tol", 1e-6))
        tie_tol = float(params.get("tie_tol", 1e-5))
        result = plar_reduce(source=gran, delta=delta, warm_start=prev, **params)
        k = valid_prefix_len(result.theta_history[: len(prev)], result.theta_full,
                             tol=tol, tie_tol=tie_tol)
        sp.set(kept=k, reruns=int(k != len(prev)))
        if k == len(prev):
            return result, k
        result = plar_reduce(source=gran, delta=delta, warm_start=prev[:k],
                             **params)
    return result, k


def repair_reduce_many(
    gran: Granularity,
    configs: Sequence[dict],
    prevs: Sequence[Optional[Sequence[int]]],
    **shared,
) -> Tuple["list[ReductionResult]", "list[int]"]:
    """The batched twin of :func:`repair_reduce`: one *stacked* dispatch
    repairs (or cold-runs) a heterogeneous group of configs over one
    granularity (DESIGN.md §3.9).

    ``configs[j]`` is a per-config dict (``delta`` + §3.8 grid knobs);
    ``prevs[j]`` is the previous reduct to warm-resume from (``None``/empty
    = cold member: core computed, greedy from scratch).  The whole group
    runs through ONE :func:`~repro_torch.core.reduction.plar_reduce_ensemble`
    call — warm members ride the per-config ``warm_start`` operand — then
    every warm member validates its prefix with :func:`valid_prefix_len`,
    and only the *trimmed* members re-run, again as one (smaller) stacked
    grid.  Returns ``(results, prefix_kept)`` in input order.  Runs on the
    granularity's device unless ``shared`` names another.

    Parity contract: member ``j`` is byte-identical (reduct + Θ history) to
    the solo path — ``repair_reduce(gran, prevs[j], ...)`` when warm,
    ``plar_reduce(source=gran, ...)`` when cold — because the stacked
    engine's per-config trajectories are byte-identical to sequential runs
    (§3.8) and the validate/trim/retry logic here is the same code path as
    the solo repair.  Answers therefore never depend on how the serving
    scheduler happened to group queries.
    """
    if len(configs) != len(prevs):
        raise ValueError(
            f"configs ({len(configs)}) and prevs ({len(prevs)}) must align")
    shared = {"device": gran.device, **shared}

    def member(cfg: dict, prev) -> dict:
        prev = [int(a) for a in prev] if prev else None
        return {**cfg, "warm_start": prev} if prev else dict(cfg)

    grid = [member(c, p) for c, p in zip(configs, prevs)]
    results = list(plar_reduce_ensemble(source=gran, configs=grid, **shared))

    kept = [0] * len(grid)
    retry_idx: list = []
    for j, (cfg, prev) in enumerate(zip(configs, prevs)):
        if not prev:
            continue
        tol = float(cfg.get("tol", 1e-6))
        tie_tol = float(cfg.get("tie_tol", 1e-5))
        k = valid_prefix_len(
            results[j].theta_history[: len(prev)], results[j].theta_full,
            tol=tol, tie_tol=tie_tol)
        kept[j] = k
        if k < len(prev):
            retry_idx.append(j)
    if retry_idx:
        # a fully-trimmed prefix retries with warm_start=[] — greedy from
        # scratch with the core skipped, exactly repair_reduce's
        # ``plar_reduce(warm_start=prev[:0])`` retry
        retry_grid = [
            {**configs[j],
             "warm_start": [int(a) for a in prevs[j][: kept[j]]]}
            for j in retry_idx
        ]
        fresh = plar_reduce_ensemble(source=gran, configs=retry_grid, **shared)
        for j, r in zip(retry_idx, fresh):
            results[j] = r
    return results, kept


@dataclasses.dataclass
class DatasetHandle:
    """Device-resident state of one evolving dataset (DESIGN.md §3.7).

    Holds the live :class:`Granularity`, the last
    :class:`~repro_torch.core.reduction.ReductionResult` per reduction config
    (the warm-start prefixes and their Θ histories), and a content
    fingerprint.  ``update`` absorbs a row batch in O(batch + live granules)
    via the §3.6 monoid merge; ``reduce`` answers with a warm repair when a
    previous result exists for the config, a cold run otherwise.  Everything
    lives on :attr:`device`, the granularity's.
    """

    gran: Granularity
    exact: bool = True
    n_updates: int = 0
    rows_absorbed: int = 0
    last_prefix_kept: int = 0
    last_was_warm: bool = False
    # shard lineage (DESIGN.md §3.10): set by create_sharded(); persisted by
    # service/checkpoint.py as replay metadata — a lost shard re-folds from
    # its recorded chunk ranges instead of triggering a full rebuild
    lineage: Optional[Tuple[ShardLineage, ...]] = None
    _sharded: Optional[ShardedBuild] = None
    _results: Dict[tuple, ReductionResult] = dataclasses.field(
        default_factory=dict)
    _fp: Optional[int] = None  # fingerprint cache, invalidated by update()

    @property
    def device(self) -> torch.device:
        return self.gran.device

    @property
    def _guard(self):
        return device_guard(self.gran.device)

    @classmethod
    def create(cls, x=None, d=None, *, source=None, n_dec: Optional[int] = None,
               v_max: Optional[int] = None, exact: bool = True,
               chunk_rows: int = 65536,
               device: DeviceLike = "cuda") -> "DatasetHandle":
        """Build the initial granularity on ``device`` from arrays, a
        GranuleSource, or a prebuilt Granularity.  Raw arrays require
        explicit ``n_dec``/``v_max``: an online dataset will see rows beyond
        the first batch, so inferred cardinalities would make later updates
        ill-defined (merge metadata must match, and packed ids must stay in
        range).
        """
        if source is None and (n_dec is None or v_max is None):
            raise ValueError(
                "DatasetHandle.create from raw arrays requires explicit "
                "n_dec and v_max (future updates must fit the declared "
                "cardinalities)")
        dev = resolve_device(device)
        with device_guard(dev).shared():
            gran = resolve_granularity(
                x, d, source=source, n_dec=n_dec, v_max=v_max, exact=exact,
                chunk_rows=chunk_rows, device=dev)
            rows = int(gran.n_total)
        return cls(gran=gran, exact=exact, rows_absorbed=rows)

    @classmethod
    def create_sharded(cls, source, n_shards: int, *,
                       chunk_rows: int = 65536, exact: bool = True,
                       fault_plan=None,
                       device: DeviceLike = "cuda") -> "DatasetHandle":
        """Build from a GranuleSource as ``n_shards`` lineage-tracked data
        shards on ``device`` (:func:`~repro_torch.core.recovery.build_sharded`).
        The handle serves reductions from the merged granularity exactly
        like :meth:`create`, but keeps the per-shard granularities and their
        :class:`~repro_torch.core.recovery.ShardLineage` recipes alive so a
        lost shard costs one re-fold (:meth:`recover_shards`), not a rebuild.
        """
        dev = resolve_device(device)
        with device_guard(dev).shared():
            build = build_sharded(source, n_shards, chunk_rows=chunk_rows,
                                  exact=exact, fault_plan=fault_plan,
                                  device=dev)
            rows = int(build.merged.n_total)
        h = cls(gran=build.merged, exact=exact, rows_absorbed=rows,
                lineage=tuple(build.lineages))
        h._sharded = build
        return h

    @property
    def lost_shards(self) -> "list[int]":
        return list(self._sharded.lost) if self._sharded is not None else []

    def drop_shard(self, shard_index: int) -> None:
        """Simulate shard loss (the chaos harness's shard_drop fault)."""
        if self._sharded is None:
            raise ShardLost(
                "handle holds no sharded build (create_sharded required)",
                shard_index=shard_index)
        self._sharded.drop(shard_index)

    def recover_shards(self, source) -> "list[int]":
        """Re-fold every lost shard from its lineage and re-merge.

        The recovered merged granularity is bitwise identical to the
        pre-loss one (deterministic replay, §3.10), so the fingerprint —
        and every cached reduct's validity — is unchanged; asserted by
        tests/test_torch_recovery.py.  Raises :class:`ShardLost` when the
        handle has no lineage to replay from.
        """
        if self._sharded is None:
            raise ShardLost("handle holds no shard lineage to recover from")
        with self._guard.shared():
            recovered = recover(self._sharded, source)
        if recovered:
            self.gran = self._sharded.merged
            self._fp = None
        return recovered

    @property
    def fingerprint(self) -> int:
        if self._fp is None:
            with self._guard.shared():
                self._fp = granularity_fingerprint(self.gran)
        return self._fp

    @property
    def n_granules(self) -> int:
        with self._guard.shared():
            return int(self.gran.num)

    def validate_batch(self, x, d) -> Tuple[np.ndarray, np.ndarray]:
        """Check a row batch against the declared schema *without* folding
        (host numpy only: no device work).

        Exposed so the server can reject bad batches at ``update()`` time —
        before they are buffered next to valid ones — rather than losing the
        whole coalesced merge at query time.  Span ``service.validate``.
        """
        with obs.span("service.validate") as sp:
            x = np.asarray(x, np.int32)
            d = np.asarray(d, np.int32)
            if x.ndim != 2 or x.shape[1] != self.gran.n_attrs:
                raise ValueError(
                    f"update batch has {x.shape[1] if x.ndim == 2 else '?'} "
                    f"attributes, dataset has {self.gran.n_attrs}")
            sp.set(rows=x.shape[0])
            if d.shape != (x.shape[0],):
                raise ValueError(
                    f"decision shape {d.shape} does not match {x.shape[0]} rows")
            if x.size and not 0 <= int(x.min()) <= int(x.max()) < self.gran.v_max:
                raise ValueError(
                    f"update batch values [{int(x.min())}, {int(x.max())}] "
                    f"outside the declared v_max range [0, {self.gran.v_max})")
            if d.size and not 0 <= int(d.min()) <= int(d.max()) < self.gran.n_dec:
                raise ValueError(
                    f"update batch decisions [{int(d.min())}, {int(d.max())}] "
                    f"outside the declared n_dec range [0, {self.gran.n_dec})")
        return x, d

    def update(self, x, d) -> None:
        """Fold one row batch into the granularity (one monoid merge).

        Capacity follows the §3.6 pow2 policy (``fold_chunk``), so the
        engine's static ``n_bins = cap·v_max`` — and therefore its capture —
        only changes when the live granule count crosses a power of two.
        """
        x, d = self.validate_batch(x, d)
        with self._guard.shared():
            folded = fold_chunk(self.gran, x, d, n_dec=self.gran.n_dec,
                                v_max=self.gran.v_max, exact=self.exact,
                                device=self.device)
        if folded is not self.gran:  # empty batches are identity
            self.gran = folded
            self._fp = None
            # streamed rows are not replayable from the source lineage —
            # once the handle absorbs online updates, durability comes from
            # checkpoints (service/checkpoint.py), not shard re-folds
            self._sharded = None
            self.lineage = None
        self.n_updates += 1
        self.rows_absorbed += int(x.shape[0])

    def reduce(self, delta: str = "PR", *, warm: bool = True,
               **params) -> ReductionResult:
        """Reduct for the current granularity under ``(delta, params)``.

        Warm-repairs from the last result of the same config when one
        exists (``warm=False`` forces a cold run — the benchmark baseline).
        The handle's ``exact`` mode rides along unless the caller overrides
        it, so a hashed-id (``exact=False``) handle is reduced with the same
        id regime it was built and updated with.
        """
        params = {"exact": self.exact, **params}
        key = (delta, tuple(sorted(params.items())))
        with self._guard.dispatch:
            prev = self._results.get(key)
            if warm and prev is not None:
                r, kept = repair_reduce(self.gran, prev.reduct, delta=delta,
                                        **params)
                self.last_prefix_kept = kept
                self.last_was_warm = True
            else:
                r = plar_reduce(source=self.gran, delta=delta,
                                device=self.device, **params)
                self.last_prefix_kept = 0
                self.last_was_warm = False
            self._results[key] = r
        return r

    def reduce_many(self, queries, **shared) -> "list[ReductionResult]":
        """A heterogeneous group of single-config queries as ONE stacked
        dispatch — the scheduler's batched hot path (DESIGN.md §3.9).

        ``queries`` is a list of ``(delta, params)`` pairs whose ``params``
        are per-config §3.8 grid knobs; ``shared`` holds the group's common
        driver kwargs (``backend``, ``mode``, ...), with the handle's
        ``exact`` mode riding along like :meth:`reduce`.  Each member
        warm-resumes from the handle's previous result for the same config
        when one exists (:func:`repair_reduce_many` — stacked validate/
        trim/retry), runs cold otherwise, and lands in the per-config
        result table under the same key :meth:`reduce` uses, so the two
        paths warm-start each other.  Returns ``(results, prefix_kept,
        was_warm)`` in query order; results are byte-identical to serving
        each query alone through :meth:`reduce`.
        """
        shared = {"exact": self.exact, **shared}
        with self._guard.dispatch:
            configs, prevs, keys = [], [], []
            for delta, params in queries:
                config = {"delta": delta, **dict(params)}
                key = self.ensemble_result_key(config, shared)
                prev = self._results.get(key)
                configs.append(config)
                prevs.append(list(prev.reduct) if prev is not None else None)
                keys.append(key)
            results, kept = repair_reduce_many(self.gran, configs, prevs,
                                               **shared)
            for key, r in zip(keys, results):
                self._results[key] = r
        was_warm = [p is not None for p in prevs]
        self.last_was_warm = any(was_warm)
        self.last_prefix_kept = max(kept) if kept else 0
        return results, kept, was_warm

    @staticmethod
    def ensemble_result_key(config: dict, shared: dict) -> tuple:
        """The ``_results`` key an ensemble member is stored under.

        Built from the *explicitly provided* per-config fields (defaults not
        filled in) merged over the shared driver kwargs — the same shape
        :meth:`reduce` keys with, so ``reduce(delta, **same_params)`` later
        warm-starts from the matching ensemble member.  Bagged members carry
        their ``seed`` in the key and therefore never collide with unbagged
        reductions.
        """
        delta = config.get("delta", "PR")
        params = {**shared, **{k: v for k, v in config.items() if k != "delta"}}
        return (delta, tuple(sorted(params.items())))

    def reduce_ensemble(self, configs, *, seeds=None,
                        **shared) -> "list[ReductionResult]":
        """A whole config grid over the current granularity in one stacked
        engine dispatch (:func:`~repro_torch.core.reduction.plar_reduce_ensemble`).

        ``configs``/``seeds`` follow the driver's grid semantics (configs ×
        bag seeds); ``shared`` kwargs (``backend``, ``ladder``, ``mode``,
        per-config defaults like ``tol``) go to the driver, with the
        handle's ``exact`` mode riding along like :meth:`reduce`.  Every
        member lands in the per-config result table under
        :meth:`ensemble_result_key`, so later single-config ``reduce``
        calls with matching params warm-start from it.
        """
        shared = {"exact": self.exact, **shared}
        grid = expand_ensemble_grid(configs, seeds)
        with self._guard.dispatch:
            results = plar_reduce_ensemble(
                source=self.gran, configs=grid, device=self.device, **shared)
            for c, r in zip(grid, results):
                self._results[self.ensemble_result_key(c, shared)] = r
        self.last_prefix_kept = 0
        self.last_was_warm = False
        return results
