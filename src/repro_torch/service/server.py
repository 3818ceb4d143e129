"""Async multi-tenant reduct server: batched dispatch, dedup, admission.

The serving layer of DESIGN.md §3.7/§3.9, shaped like ``serving/engine.py``'s
Request pattern: requests enter a *bounded* asyncio queue, one scheduler
task (:class:`~repro_torch.service.scheduler.Scheduler`) drains it in windows,
and the expensive device work runs in threads so the event loop stays
responsive for admission, dedup, and rejection.

Operations:

* ``submit(name, ...)``  — create a :class:`DatasetHandle` (initial rows,
  a GranuleSource, or a prebuilt Granularity);
* ``update(name, x, d)`` — enqueue a row batch.  Updates are *lazy*: they
  buffer per dataset and are **coalesced into one monoid merge** when the
  next query for that dataset is served — k buffered batches cost one
  concat + one ``merge_granularity``, not k (the §3.6 merge is a monoid, so
  coalescing is exact);
* ``query(name, delta, **params)`` — reduct for the dataset's *current*
  content (pending updates drain first).  Served through two cache tiers:

  - **in-flight dedup** — an identical query (same dataset *content
    epoch*, measure, normalized params) that arrives while one is already
    queued or running awaits the same future instead of re-running;
  - **result cache** — keyed ``(dataset, content fingerprint, measure,
    normalized params)``; a repeat query on unchanged content is a
    dictionary hit, a changed fingerprint falls through to the handle's
    warm validate-and-repair path (state.py), and a merge evicts the
    dataset's superseded-fingerprint entries through a per-dataset
    fingerprint index (O(evicted), not O(total cache));

* ``query_ensemble(name, configs, seeds=..., **shared)`` — a whole config
  grid in one stacked engine dispatch (DESIGN.md §3.8), cached per config
  under the same key shape: only the grid's cache *misses* are re-run (as
  a smaller stacked grid).

Cross-query batching: compatible single-config cache misses that share a
scheduler window are answered by ONE stacked ``reduce_many`` dispatch
(§3.9) — byte-identical to serving each alone.  ``batching=False``
restores the single-flight worker (the baseline batching is measured against).

Admission control: the queue depth is bounded (``max_queue``); when it is
full, ``query``/``query_ensemble`` fail fast with
:class:`~repro_torch.service.errors.ServerOverloaded` instead of queueing
unboundedly.  ``stop()`` fails queued-but-unstarted requests with
:class:`~repro_torch.service.errors.ServerStopped` — futures never hang across
shutdown — then **flushes** every buffered-but-unmerged update batch
through one final coalesced merge per dataset (counted as
``flushed_batches`` in :meth:`ReductServer.summary`), so accepted updates
are never silently dropped by an orderly shutdown.

Durability & resilience (DESIGN.md §3.10): with ``checkpoint_dir`` set,
the server checkpoints its :class:`DatasetHandle` map — granularity
arrays, content fingerprint, per-config reducts/Θ histories, shard lineage
— after every ``checkpoint_every``-th merged window (background write) and
once more, blocking, at ``stop()``.  A restarted server restores the
newest committed step in :meth:`start` and answers its first query through
the warm ``repair_reduce`` path.  ``retry``/``serve_stale``/``fault_plan``
configure the scheduler's failure hardening (scheduler.py docstring);
failures are surfaced through the typed
:class:`~repro_torch.service.errors.ServiceError` hierarchy.

The port's ``repro.service.server``.  A server serves one device
(``device="cuda"`` by default: no card is an error, never a silent CPU
run): every handle it builds or restores lives there.
"""
from __future__ import annotations

import asyncio
import collections
import dataclasses
import threading
from typing import Any, Deque, Dict, List, Optional, Set, Tuple

import numpy as np

from repro_torch import obs
from repro_torch.core.reduction import ReductionResult, expand_ensemble_grid
from repro_torch.device import DeviceLike, resolve_device

from .checkpoint import ServiceCheckpointer
from .errors import (
    QueryPoisoned,
    ServerOverloaded,
    ServerStopped,
    ServiceError,
)
from .metrics import RequestTiming, ServiceMetrics
from .scheduler import RetryPolicy, Scheduler
from .state import DatasetHandle

__all__ = ["ReductServer", "ReduceRequest", "ServerOverloaded"]

_STOP = object()

# Completed-request log depth (introspection/stats only — not correctness).
_REQUEST_LOG = 1024

# Key params consumed at f32 precision by the engine (measures.f32_threshold):
# f32-rounding them in cache/dedup keys conflates only queries whose
# thresholds the engine cannot tell apart.
_F32_KEY_PARAMS = ("tol", "tie_tol")


def _norm_key_value(key: str, value: Any) -> Any:
    """Normalize one cache/dedup key value (the engine factories' idiom):
    numpy scalars become python scalars, f32-consumed thresholds round to
    f32 — so ``np.float32(0.01)`` and ``0.01`` hash to ONE key."""
    if isinstance(value, np.generic):
        value = value.item()
    if key in _F32_KEY_PARAMS and isinstance(value, float):
        value = float(np.float32(value))
    return value


def _norm_items(params: Dict[str, Any]) -> Tuple[Tuple[str, Any], ...]:
    return tuple(sorted((k, _norm_key_value(k, v)) for k, v in params.items()))


@dataclasses.dataclass
class ReduceRequest:
    """One query through the queue (the serving/engine.py Request shape)."""

    rid: int
    dataset: str
    delta: str
    params: Tuple[Tuple[str, Any], ...]
    future: asyncio.Future
    # ensemble queries: the expanded config grid (sorted-items tuples);
    # None marks a single-config query
    configs: Optional[Tuple[Tuple[Tuple[str, Any], ...], ...]] = None
    # latency accounting (shared shape with serving/engine.py):
    timing: RequestTiming = dataclasses.field(default_factory=RequestTiming)
    # filled by the scheduler:
    cached: bool = False
    warm: bool = False
    prefix_kept: int = 0
    merged_batches: int = 0
    epoch: int = 0        # the dataset's update count its answer reflects
    batch_size: int = 0   # queries served by this request's engine dispatch
    latency_s: float = 0.0


class ReductServer:
    """Stateful attribute-reduction service over evolving decision tables.

    ``max_queue`` bounds the request queue (admission control);
    ``batching=False`` restores the single-flight worker with dedup
    disabled — the baseline batching is measured against.

    Resilience knobs (DESIGN.md §3.10): ``checkpoint_dir`` enables durable
    handle snapshots (restored on :meth:`start`, written after every
    ``checkpoint_every``-th merged window and at :meth:`stop`, keep-N =
    ``checkpoint_keep``); ``retry`` is the scheduler's
    :class:`~repro_torch.service.scheduler.RetryPolicy`; ``serve_stale=True``
    degrades failed dispatches to the last known-good result flagged
    ``stale=True``; ``fault_plan`` wires a deterministic
    :class:`~repro_torch.service.faults.FaultPlan` into every injection site.
    ``device`` is where every dataset of the server lives.
    """

    def __init__(self, *, max_queue: int = 1024, batching: bool = True,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_every: int = 1, checkpoint_keep: int = 3,
                 retry: Optional[RetryPolicy] = None,
                 serve_stale: bool = False, fault_plan=None,
                 device: DeviceLike = "cuda") -> None:
        self.device = resolve_device(device)
        self._max_queue = int(max_queue)
        self._batching = bool(batching)
        self._checkpoint_dir = checkpoint_dir
        self._checkpoint_every = max(1, int(checkpoint_every))
        self._checkpoint_keep = int(checkpoint_keep)
        self._retry = retry
        self._serve_stale = bool(serve_stale)
        self._fault_plan = fault_plan
        self._ckpt: Optional[ServiceCheckpointer] = None
        self._merges_since_ckpt = 0
        # §3.10 failure bookkeeping, keyed by query config *without* the
        # content fingerprint (scheduler._qkey): consecutive-failure counts,
        # quarantined configs, and last known-good results for serve_stale
        self._failures: Dict[tuple, int] = {}
        self._quarantined: Dict[tuple, QueryPoisoned] = {}
        self._last_good: Dict[tuple, ReductionResult] = {}
        # None marks a name reserved by an in-flight submit()
        self._handles: Dict[str, Optional[DatasetHandle]] = {}
        self._pending: Dict[str, List[Tuple[np.ndarray, np.ndarray]]] = {}
        # content epoch per dataset: bumped on every update(); dedup keys
        # carry it so only queries over the same eventual content share a
        # future (the fingerprint is not known until the merge lands)
        self._epoch: Dict[str, int] = {}
        # result cache, keyed (dataset, fingerprint, measure, params), plus
        # a dataset → fingerprint → keys index so stale eviction touches
        # only the evicted entries
        self._cache: Dict[tuple, ReductionResult] = {}
        self._cache_index: Dict[str, Dict[int, Set[tuple]]] = {}
        self._lock = threading.Lock()
        # in-flight dedup tier: dedup key → the future already serving it
        self._inflight: Dict[tuple, asyncio.Future] = {}
        self._queue: Optional[asyncio.Queue] = None
        self._worker: Optional[asyncio.Task] = None
        self._stopping = False
        self._rid = 0
        self.requests: Deque[ReduceRequest] = collections.deque(
            maxlen=_REQUEST_LOG)
        # one per-server registry (DESIGN.md §3.11) backs both the stats
        # dict and the ServiceMetrics counters/histograms; reduce_server's
        # --metrics-port merges it into the process exposition
        self.registry = obs.MetricsRegistry()
        self.metrics = ServiceMetrics(registry=self.registry)
        self.stats = obs.CounterMap(
            self.registry, prefix="plar_server_",
            initial=("queries", "cache_hits", "warm", "cold",
                     "merges", "updates", "coalesced_batches",
                     "ensemble_queries", "ensemble_configs",
                     "dedup_hits", "rejected", "engine_runs",
                     "retries", "quarantined", "stale_served",
                     "flushed_batches", "flush_failures",
                     "checkpoints", "restored_datasets"))

    # -- lifecycle ----------------------------------------------------------

    async def start(self) -> "ReductServer":
        if self._worker is not None:
            raise ServiceError("server already started")
        if self._checkpoint_dir is not None:
            # postmortems land next to the checkpoints (obs dump-on-failure)
            obs.set_dump_dir(self._checkpoint_dir)
            self._ckpt = ServiceCheckpointer(
                self._checkpoint_dir, keep=self._checkpoint_keep,
                fault_plan=self._fault_plan, device=self.device)
            try:
                _step, restored = await asyncio.to_thread(self._ckpt.restore)
            except FileNotFoundError:
                pass  # cold start: no committed step yet
            else:
                for name, handle in restored.items():
                    # live handles win over checkpointed state (a stop/start
                    # cycle must not roll a dataset back)
                    self._handles.setdefault(name, handle)
                self._bump("restored_datasets", len(restored))
        self._queue = asyncio.Queue(maxsize=self._max_queue)
        self._scheduler = Scheduler(
            self, batching=self._batching, retry=self._retry,
            fault_plan=self._fault_plan, serve_stale=self._serve_stale)
        self._worker = asyncio.create_task(self._scheduler.run(_STOP))
        return self

    async def stop(self) -> None:
        """Orderly shutdown.  The window being dispatched completes; every
        queued-but-unstarted request fails fast with
        :class:`ServerStopped` (futures never hang).  Then buffered-but-
        unmerged update batches are flushed through one final coalesced
        merge per dataset (``flushed_batches``), and — when checkpointing —
        a final blocking checkpoint makes the flushed state durable."""
        if self._worker is None:
            return
        self._stopping = True
        try:
            await self._queue.put(_STOP)
            await self._worker
            await asyncio.to_thread(self._flush_pending)
            if self._ckpt is not None:
                await asyncio.to_thread(self._checkpoint_now)
                await asyncio.to_thread(self._ckpt.wait)
        finally:
            self._worker = None
            self._queue = None
            self._inflight.clear()
            self._stopping = False

    async def __aenter__(self) -> "ReductServer":
        return await self.start()

    async def __aexit__(self, *exc) -> None:
        await self.stop()

    # -- operations ---------------------------------------------------------

    async def submit(self, name: str, x=None, d=None, *, source=None,
                     n_dec: Optional[int] = None, v_max: Optional[int] = None,
                     exact: bool = True, chunk_rows: int = 65536,
                     n_shards: Optional[int] = None) -> int:
        """Create a dataset on the server's device; returns its content
        fingerprint.

        ``n_shards`` (requires ``source=``) builds through the lineage-
        tracked sharded path (core/recovery.py): the handle records per
        shard which source chunk ranges folded into it, so a lost shard is
        rebuilt by re-folding only its own rows."""
        if name in self._handles:
            raise ValueError(f"dataset {name!r} already exists")
        if self._checkpoint_dir is not None and "/" in name:
            raise ValueError(
                f"dataset name {name!r} must not contain '/' when "
                f"checkpointing is enabled (names become npz key prefixes)")
        # reserve before awaiting: the to_thread suspension would otherwise
        # let a concurrent same-name submit pass the existence check too,
        # and the last writer would silently swallow the other's rows
        self._handles[name] = None
        try:
            if n_shards is not None:
                if source is None:
                    raise ValueError("n_shards requires source=")
                handle = await asyncio.to_thread(
                    DatasetHandle.create_sharded, source, n_shards,
                    chunk_rows=chunk_rows, exact=exact,
                    fault_plan=self._fault_plan, device=self.device)
            else:
                handle = await asyncio.to_thread(
                    DatasetHandle.create, x, d, source=source, n_dec=n_dec,
                    v_max=v_max, exact=exact, chunk_rows=chunk_rows,
                    device=self.device)
        except BaseException:
            del self._handles[name]
            raise
        self._handles[name] = handle
        return await asyncio.to_thread(lambda: handle.fingerprint)

    async def update(self, name: str, x, d) -> None:
        """Buffer a row batch; applied (coalesced) before the next query.

        Validated against the dataset's declared schema *now*: a bad batch
        is rejected to its sender instead of poisoning the coalesced merge
        (which would silently drop the valid batches buffered beside it).
        """
        with obs.span("server.update", dataset=name) as sp:
            handle = self._require(name)
            x, d = handle.validate_batch(x, d)
            self._pending.setdefault(name, []).append((x, d))
            self._epoch[name] = self._epoch.get(name, 0) + 1
            self.stats["updates"] += 1
            sp.set(epoch=self._epoch[name])

    async def query(self, name: str, delta: str = "PR",
                    **params) -> ReductionResult:
        """Reduct for the dataset's current content (pending updates included).

        Raises :class:`ServerOverloaded` when the bounded queue is full."""
        self._require(name)
        self._ensure_running()
        params_t = _norm_items(params)
        dkey = None
        if self._batching:
            dkey = (name, self._epoch.get(name, 0), delta, params_t, None)
            fut = self._inflight.get(dkey)
            if fut is not None:  # in-flight dedup: ride the running query
                self._bump("dedup_hits", 1)
                self.metrics.inc("dedup_hits")
                obs.event("scheduler.dedup", dataset=name, delta=delta)
                return await asyncio.shield(fut)
        self._rid += 1
        req = ReduceRequest(
            rid=self._rid, dataset=name, delta=delta, params=params_t,
            future=asyncio.get_running_loop().create_future(),
            timing=RequestTiming().mark_enqueue())
        self._admit(req, dkey)
        if dkey is not None:
            # shield: a cancelled caller must not cancel a shared future
            return await asyncio.shield(req.future)
        return await req.future

    async def query_ensemble(self, name: str, configs, *, seeds=None,
                             **shared) -> List[ReductionResult]:
        """A whole config grid for the dataset's current content, served by
        ONE stacked engine dispatch (DESIGN.md §3.8).

        Pending updates drain first, exactly like :meth:`query`.  Each
        member is cached individually under ``(dataset, fingerprint, delta,
        params)`` — a repeat grid on unchanged content is C dictionary hits,
        a partially-cached grid re-runs only the missing configs (as a
        smaller stacked grid), and results come back in grid order
        (``configs`` × ``seeds``).
        """
        self._require(name)
        self._ensure_running()
        grid = expand_ensemble_grid(configs, seeds)
        params_t = _norm_items(shared)
        configs_t = tuple(_norm_items(c) for c in grid)
        dkey = None
        if self._batching:
            dkey = (name, self._epoch.get(name, 0), "<ensemble>", params_t,
                    configs_t)
            fut = self._inflight.get(dkey)
            if fut is not None:
                self._bump("dedup_hits", 1)
                self.metrics.inc("dedup_hits")
                obs.event("scheduler.dedup", dataset=name, delta="<ensemble>")
                return await asyncio.shield(fut)
        self._rid += 1
        req = ReduceRequest(
            rid=self._rid, dataset=name, delta="<ensemble>", params=params_t,
            configs=configs_t,
            future=asyncio.get_running_loop().create_future(),
            timing=RequestTiming().mark_enqueue())
        self._admit(req, dkey)
        if dkey is not None:
            return await asyncio.shield(req.future)
        return await req.future

    def handle(self, name: str) -> DatasetHandle:
        return self._require(name)

    def summary(self) -> Dict[str, Any]:
        """One flat dict: counters + aggregate serving metrics."""
        out = dict(self.stats)
        out.update(self.metrics.summary())
        return out

    # -- admission / dedup (event loop) -------------------------------------

    def _ensure_running(self) -> None:
        if self._stopping:
            raise ServerStopped("server stopped")
        if self._queue is None:
            raise ServiceError(
                "server not started (use 'async with' or start())")

    def _admit(self, req: ReduceRequest, dkey: Optional[tuple]) -> None:
        try:
            self._queue.put_nowait(req)
        except asyncio.QueueFull:
            self._bump("rejected", 1)
            self.metrics.inc("rejected")
            raise ServerOverloaded(
                f"request queue full (max_queue={self._max_queue}); "
                f"retry after the backlog drains") from None
        if dkey is not None:
            self._inflight[dkey] = req.future
            req.future.add_done_callback(self._inflight_cleanup(dkey))

    def _inflight_cleanup(self, dkey: tuple):
        def _done(fut: asyncio.Future) -> None:
            if self._inflight.get(dkey) is fut:
                del self._inflight[dkey]
        return _done

    # -- shared state used by the scheduler (threads) -----------------------

    def _require(self, name: str) -> DatasetHandle:
        handle = self._handles.get(name)
        if handle is None:  # absent, or reserved by an in-flight submit
            raise KeyError(f"unknown dataset: {name!r}")
        return handle

    def _bump(self, name: str, by: int = 1) -> None:
        with self._lock:
            self.stats[name] = self.stats.get(name, 0) + by

    def _cache_get(self, key: tuple) -> Optional[ReductionResult]:
        with self._lock:
            return self._cache.get(key)

    def _cache_put(self, key: tuple, value) -> None:
        with self._lock:
            self._cache[key] = value
            self._cache_index.setdefault(key[0], {}).setdefault(
                key[1], set()).add(key)

    def _evict_stale(self, dataset: str, live_fp: int) -> None:
        """Drop a dataset's superseded-fingerprint entries: O(evicted) via
        the fingerprint index, not a scan of the whole cache."""
        with self._lock:
            by_fp = self._cache_index.get(dataset)
            if not by_fp:
                return
            for fp in [f for f in by_fp if f != live_fp]:
                for key in by_fp.pop(fp):
                    self._cache.pop(key, None)

    # -- §3.10 failure bookkeeping (scheduler threads) ----------------------

    def _poisoned(self, qkey: tuple) -> Optional[QueryPoisoned]:
        """The quarantine exception for this query config, if poisoned."""
        with self._lock:
            return self._quarantined.get(qkey)

    def _record_failure(self, qkey: tuple, exc: BaseException,
                        quarantine_after: int) -> None:
        """Count one exhausted dispatch failure; quarantine the config once
        it has failed ``quarantine_after`` times (followers then get the
        typed :class:`QueryPoisoned` without re-running the dispatch)."""
        quarantined_now = False
        with self._lock:
            n = self._failures.get(qkey, 0) + 1
            self._failures[qkey] = n
            if n >= quarantine_after and qkey not in self._quarantined:
                self._quarantined[qkey] = QueryPoisoned(
                    f"query {qkey[1]!r} on dataset {qkey[0]!r} quarantined "
                    f"after {n} failed dispatches "
                    f"({type(exc).__name__}: {exc}); quarantine clears when "
                    f"the dataset's content changes",
                    cause=exc, failures=n)
                self.stats["quarantined"] = self.stats.get(
                    "quarantined", 0) + 1
                quarantined_now = True
        if quarantined_now:  # outside the lock: dump serialization is slow
            obs.event("server.quarantine", dataset=qkey[0], query=qkey[1],
                      failures=n, error=f"{type(exc).__name__}: {exc}")
            obs.request_dump(
                f"quarantine-{qkey[0]}",
                meta={"dataset": qkey[0], "query": repr(qkey[1]),
                      "failures": n,
                      "error": f"{type(exc).__name__}: {exc}"})

    def _clear_failures(self, dataset: str) -> None:
        """Content changed (merge landed): the failure may have been a
        property of the old content — give the dataset's configs a clean
        quarantine slate."""
        with self._lock:
            for d in (self._failures, self._quarantined):
                for k in [k for k in d if k[0] == dataset]:
                    del d[k]

    def _last_good_put(self, qkey: tuple, result: ReductionResult) -> None:
        with self._lock:
            self._last_good[qkey] = result

    def _last_good_get(self, qkey: tuple) -> Optional[ReductionResult]:
        with self._lock:
            return self._last_good.get(qkey)

    # -- §3.10 durability (event loop + threads) ----------------------------

    @property
    def checkpointer(self) -> Optional[ServiceCheckpointer]:
        return self._ckpt

    def _note_merged(self) -> None:
        """Called by the scheduler after a window that merged updates:
        schedule a background checkpoint every ``checkpoint_every`` merged
        windows (the serving path never waits on disk)."""
        if self._ckpt is None:
            return
        self._merges_since_ckpt += 1
        if self._merges_since_ckpt >= self._checkpoint_every:
            self._checkpoint_now(blocking=False)

    def _checkpoint_now(self, *, blocking: bool = True) -> None:
        """Snapshot every live handle as one committed step (skips names
        reserved by in-flight submits).  Write failures are absorbed by the
        checkpointer (``failed_saves``/``last_error``) — durability must not
        take the serving path down."""
        if self._ckpt is None:
            return
        path = self._ckpt.save(dict(self._handles), blocking=blocking)
        if path is not None:
            self._bump("checkpoints", 1)
        self._merges_since_ckpt = 0

    def _flush_pending(self) -> None:
        """One final coalesced merge per dataset for batches that were
        buffered but never demanded by a query (stop() calls this): accepted
        updates survive an orderly shutdown.  A failing dataset is counted
        (``flush_failures``) and skipped — it must not block the others."""
        for name in list(self._pending):
            batches = self._pending.pop(name)
            handle = self._handles.get(name)
            if not batches or handle is None:
                continue
            try:
                xs = np.concatenate([b[0] for b in batches])
                ds = np.concatenate([b[1] for b in batches])
                handle.update(xs, ds)
            except BaseException:
                self._bump("flush_failures", len(batches))
                continue
            self._bump("merges", 1)
            self._bump("coalesced_batches", len(batches))
            self._bump("flushed_batches", len(batches))
            self._evict_stale(name, handle.fingerprint)
            self._clear_failures(name)
