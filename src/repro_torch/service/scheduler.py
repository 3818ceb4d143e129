"""Multi-tenant batched dispatch for the reduct server (DESIGN.md §3.9/§3.10).

A single-flight worker takes one queue and one request per engine
dispatch.  This scheduler replaces it with *cross-query batching* — the
continuous-batching idiom of ``serving/engine.py`` applied to attribute
reduction:

* **Window** — when a request is picked up, the queue is drained
  non-blocking; everything already queued forms the batching window.
  Requests arriving during a dispatch wait for the next window, so the
  window needs no timer and adds zero latency to a lone request.
* **Grouping** — window requests are grouped per dataset.  Within a
  dataset, cache misses whose ``(delta, params)`` can be expressed on the
  stacked §3.8 engine (``partition_reduce_params``) and whose *shared*
  knobs agree are served by ONE ``DatasetHandle.reduce_many`` dispatch:
  heterogeneous per-config knobs (measure, tol, max_features, ...) ride
  the traced `EnsembleOperands`, warm members resume from their previous
  reducts via the per-config ``warm_start`` operand.  Results are
  byte-identical to serving each query alone (stacked-vs-sequential
  parity, §3.8 + §3.7 repair), so answers never depend on grouping.
* **Merge/dispatch overlap** — each dataset's pending update batches are
  coalesced into one monoid merge on a worker thread; merges for datasets
  B, C, ... run while dataset A's engine dispatch is in flight (engine
  dispatches themselves stay serialized — serializing keeps the §3.7
  coalescing window well-defined per dataset).  On a card one part of a
  dispatch is kept apart: the engine's CUDA graph capture (``global``
  capture mode) is lost if another thread syncs or allocates while it
  runs.  The capture holds the device guard exclusively and every merge
  holds it shared (``core/guard.py``), so a merge waits for a capture and a
  capture for the merges already running, while replays and the rest of a
  dispatch overlap merges freely.
* **Admission control** — the queue is bounded; over-capacity submits
  fail fast with :class:`ServerOverloaded` (raised by the server's
  ``query``/``query_ensemble``).

Failure hardening (DESIGN.md §3.10): every engine dispatch and coalescing
merge runs through :meth:`Scheduler._attempt` — fault-plan injection,
optional timeout, and bounded exponential-backoff retry of *transient*
errors (:func:`is_transient`).  A timed-out attempt is not abandoned to a
rival: its retry waits on the same running call (:func:`_call_with_timeout`),
so a retried dispatch returns exactly the answer of an untimed one and no
two attempts replay into a runner's shared buffers, or fold one batch
twice, at once.  Deterministic errors (``ValueError`` from a
bad config) are never retried.  A query config that keeps failing is
**quarantined**: after ``RetryPolicy.quarantine_after`` exhausted attempts
its followers get a typed :class:`QueryPoisoned` immediately instead of
re-running the dispatch or wedging the shared dedup future; the quarantine
clears when the dataset's content changes (the merge may fix it).  With
``serve_stale=True`` a failed dispatch degrades gracefully: the last
known-good result for that config is served flagged ``stale=True`` instead
of erroring.  A failed *stacked* dispatch falls back to per-member solo
serves, so one poisoned member cannot take down its whole group.

The scheduler runs as one asyncio task inside :class:`ReductServer`; all
device work happens in ``asyncio.to_thread`` so the event loop keeps
admitting, deduplicating, and rejecting while engines run.

The port's ``repro.service.scheduler``, with the same windows, grouping,
retry, quarantine and stale serving, and the same span and counter names.
One port-only choice: a stacked group's configs are dispatched in a
canonical order (:meth:`Scheduler._serve_group`), because the port keys
its ensemble runner — and so its CUDA graph — on the ordered tuple of
measures; arrival order would otherwise cost a capture per permutation.
"""
from __future__ import annotations

import asyncio
import dataclasses
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch import obs
from repro_torch.core.reduction import partition_reduce_params

from .errors import QueryPoisoned, ServerOverloaded, ServerStopped
from .faults import FaultInjected

__all__ = ["Scheduler", "RetryPolicy", "ServerOverloaded", "is_transient"]


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded exponential-backoff retry for dispatches and merges.

    ``max_attempts`` counts total tries (1 = no retry); backoff sleeps
    ``base_delay_s · 2^i`` capped at ``max_delay_s`` between them — on the
    dispatching worker thread, so the event loop keeps admitting.
    ``timeout_s`` (None = off) bounds one wait for an attempt; a timed-out
    attempt counts as transient.  Python cannot preempt a running dispatch,
    so the timed-out call keeps running and the retry waits on it again
    instead of starting a second one (no duplicated work); when every
    attempt has timed out, the call finishes in the background and its
    answer is dropped.
    ``quarantine_after`` exhausted dispatch failures poison the query config
    (:class:`QueryPoisoned` for followers) until the dataset's content
    changes.
    """

    max_attempts: int = 3
    base_delay_s: float = 0.02
    max_delay_s: float = 1.0
    timeout_s: Optional[float] = None
    quarantine_after: int = 2


def is_transient(exc: BaseException) -> bool:
    """Transient (retry) vs deterministic (fail fast) classification.

    Infrastructure-shaped failures — injected faults flagged transient,
    timeouts, I/O errors — are worth retrying; ``ValueError``/``TypeError``
    and friends are properties of the *query*, and retrying them only
    burns engine time reproducing the same exception.
    """
    if isinstance(exc, FaultInjected):
        return exc.transient
    return isinstance(exc, (TimeoutError, ConnectionError, OSError))


class _Call:
    """One call of ``fn`` on a daemon worker thread, awaited with a bound."""

    def __init__(self, fn) -> None:
        self.done = threading.Event()
        self.value: Any = None
        self.error: Optional[BaseException] = None
        threading.Thread(target=self._run, args=(fn,), daemon=True).start()

    def _run(self, fn) -> None:
        try:
            self.value = fn()
        except BaseException as e:
            self.error = e
        finally:
            self.done.set()


def _call_with_timeout(fn, timeout_s: Optional[float], running: Optional[_Call] = None):
    """Run ``fn()`` with a wall-clock bound.

    On timeout ``TimeoutError`` is raised carrying the still-running call as
    its ``running`` attribute.  Passed back as ``running``, that call is
    waited on again instead of starting ``fn`` a second time — see
    RetryPolicy."""
    if not timeout_s:
        return fn()
    call = running if running is not None else _Call(fn)
    if not call.done.wait(timeout_s):
        err = TimeoutError(f"dispatch exceeded timeout_s={timeout_s}")
        err.running = call
        raise err
    if call.error is not None:
        raise call.error
    return call.value


class _Work:
    """One dataset's share of a batching window: its requests (arrival
    order) and the update batches captured for its coalesced merge."""

    __slots__ = ("dataset", "requests", "batches", "epoch", "merge_error", "merged")

    def __init__(self, dataset: str) -> None:
        self.dataset = dataset
        self.requests: List[Any] = []
        self.batches: List[Tuple[np.ndarray, np.ndarray]] = []
        self.epoch = 0        # the dataset's update count once the batches fold
        self.merge_error: Optional[BaseException] = None
        self.merged = False


class Scheduler:
    """Drains the server queue in windows and dispatches batched work.

    ``batching=False`` degrades to the single-flight worker — one
    request per window, solo dispatch — the baseline batching is measured
    against.  ``retry``/``fault_plan``/
    ``serve_stale`` are the §3.10 resilience knobs (module docstring).
    """

    def __init__(self, server, *, batching: bool = True,
                 retry: Optional[RetryPolicy] = None,
                 fault_plan=None, serve_stale: bool = False) -> None:
        self.srv = server
        self.batching = batching
        self.retry = retry or RetryPolicy()
        self.fault_plan = fault_plan
        self.serve_stale = serve_stale

    # -- resilience primitives ----------------------------------------------

    def _attempt(self, site: str, fn):
        """Fault injection + timeout + bounded-backoff retry around one
        dispatch or merge.  Transient failures retry up to
        ``retry.max_attempts``; the last error (or the first deterministic
        one) propagates to the caller's classification logic.  A timed-out
        call is carried into the next attempt, which waits on it again."""
        delay = self.retry.base_delay_s
        running: Optional[_Call] = None
        for attempt in range(self.retry.max_attempts):
            try:
                if self.fault_plan is not None:
                    self.fault_plan.inject(site)
                return _call_with_timeout(fn, self.retry.timeout_s, running)
            except BaseException as e:
                running = getattr(e, "running", running)
                if running is not None and running.error is e:
                    running = None   # that call failed: a retry calls fn afresh
                last_try = attempt + 1 >= self.retry.max_attempts
                if last_try or not is_transient(e):
                    raise
                self.srv._bump("retries", 1)
                obs.event("scheduler.retry", site=site, attempt=attempt + 1,
                          error=f"{type(e).__name__}: {e}")
                time.sleep(delay)
                delay = min(delay * 2, self.retry.max_delay_s)

    def _dispatch_failed(self, qkey: tuple, exc: BaseException,
                         stale_key: Optional[tuple]) -> Tuple[str, Any]:
        """Post-mortem of an exhausted dispatch: record the failure toward
        quarantine, then either degrade to the last known-good result
        (flagged ``stale=True``) or surface the error."""
        srv = self.srv
        srv._record_failure(qkey, exc, self.retry.quarantine_after)
        if self.serve_stale and stale_key is not None:
            stale = srv._last_good_get(stale_key)
            if stale is not None:
                srv._bump("stale_served", 1)
                obs.event("scheduler.stale_served", dataset=qkey[0],
                          query=qkey[1])
                return ("ok", dataclasses.replace(stale, stale=True))
        obs.event("scheduler.dispatch_failed", dataset=qkey[0],
                  query=qkey[1], error=f"{type(exc).__name__}: {exc}")
        return ("err", exc)

    # -- the worker loop ----------------------------------------------------

    async def run(self, stop_marker: object) -> None:
        queue = self.srv._queue
        while True:
            req = await queue.get()
            if req is stop_marker or self.srv._stopping:
                self._shutdown(stop_marker,
                               [] if req is stop_marker else [req])
                return
            window = [req]
            if self.batching:
                # the batching window: everything already queued rides along
                while True:
                    try:
                        nxt = queue.get_nowait()
                    except asyncio.QueueEmpty:
                        break
                    if nxt is stop_marker:
                        self._shutdown(stop_marker, window)
                        return
                    window.append(nxt)
            works = self._plan(window)
            with obs.span("scheduler.window", requests=len(window),
                          datasets=len(works)):
                await self._execute(works)
            if any(w.merged for w in works):
                self.srv._note_merged()

    def _shutdown(self, stop_marker: object, pending: List[Any]) -> None:
        """Drain the queue on stop: queued-but-unstarted requests fail fast
        with :class:`ServerStopped` instead of hanging forever (their work
        will never run)."""
        queue = self.srv._queue
        while True:
            try:
                nxt = queue.get_nowait()
            except asyncio.QueueEmpty:
                break
            if nxt is not stop_marker:
                pending.append(nxt)
        for req in pending:
            if not req.future.done():
                req.future.set_exception(ServerStopped("server stopped"))

    # -- planning (event loop: may touch _pending without locks) ------------

    def _plan(self, window: List[Any]) -> List[_Work]:
        """Group the window per dataset (first-arrival order) and capture
        each dataset's pending update batches for the coalesced merge."""
        works: Dict[str, _Work] = {}
        for req in window:
            work = works.get(req.dataset)
            if work is None:
                work = works[req.dataset] = _Work(req.dataset)
            work.requests.append(req)
        for work in works.values():
            work.batches = self.srv._pending.pop(work.dataset, [])
            work.epoch = self.srv._epoch.get(work.dataset, 0)
        return list(works.values())

    # -- execution ----------------------------------------------------------

    async def _execute(self, works: List[_Work]) -> None:
        # kick every dataset's coalescing merge off immediately: dataset B's
        # merge overlaps dataset A's engine dispatch (the continuous-batching
        # overlap; handles are disjoint per dataset, the result cache is
        # lock-guarded, and the device guard keeps merges out of captures)
        merges = {
            work.dataset: asyncio.create_task(
                asyncio.to_thread(self._merge, work))
            for work in works
        }
        for work in works:
            await merges[work.dataset]
            if work.merge_error is not None:
                outcomes = [(req, ("err", work.merge_error))
                            for req in work.requests]
            else:
                outcomes = await asyncio.to_thread(self._dispatch, work)
            for req, (kind, payload) in outcomes:
                if req.future.cancelled():
                    continue
                if kind == "ok":
                    req.future.set_result(payload)
                else:
                    req.future.set_exception(payload)

    def _merge(self, work: _Work) -> None:
        """Coalesce one dataset's buffered update batches into ONE monoid
        merge, then evict the dataset's superseded cache entries (runs on a
        worker thread; may overlap another dataset's engine dispatch, but
        not its capture: ``handle.update`` holds the device guard shared).
        Retried under the §3.10 policy: a transient fault mid-merge loses
        nothing — the batches stay captured in this work item and the next
        attempt re-folds them."""
        srv = self.srv
        if not work.batches:
            return
        try:
            handle = srv._handles[work.dataset]
            with obs.span("scheduler.coalesce", dataset=work.dataset, epoch=work.epoch):
                xs = np.concatenate([b[0] for b in work.batches])
                ds = np.concatenate([b[1] for b in work.batches])
            with obs.span("scheduler.merge", dataset=work.dataset, epoch=work.epoch,
                          batches=len(work.batches), rows=int(xs.shape[0])):
                self._attempt("merge", lambda: handle.update(xs, ds))
            srv._bump("merges", 1)
            srv._bump("coalesced_batches", len(work.batches))
            work.merged = True
            # content moved on: superseded-fingerprint entries can never hit
            # again — O(evicted) via the per-dataset fingerprint index —
            # and the new content gets a clean quarantine slate
            srv._evict_stale(work.dataset, handle.fingerprint)
            srv._clear_failures(work.dataset)
        except BaseException as e:  # surfaced to every request of this work
            work.merge_error = e

    def _dispatch(self, work: _Work) -> List[Tuple[Any, Tuple[str, Any]]]:
        """Serve one dataset's window share (runs on a worker thread).

        Cache probes first; misses that fit the stacked engine group into
        ``reduce_many`` dispatches (identical configs collapse — the
        window-level half of in-flight dedup); everything else runs solo.
        """
        srv = self.srv
        handle = srv._handles[work.dataset]
        fp = handle.fingerprint
        for req in work.requests:
            req.timing.mark_start()
            req.merged_batches = len(work.batches)
            req.epoch = work.epoch

        outcome: Dict[int, Tuple[str, Any]] = {}
        # stackable misses: group key (sorted shared items) → list of
        # (config, params-dict, [requests])  — identical configs share slots
        groups: Dict[tuple, List[Tuple[dict, dict, List[Any]]]] = {}

        for req in work.requests:
            srv._bump("queries", 1)
            if req.configs is not None:
                outcome[req.rid] = self._serve_ensemble(handle, req, fp)
                continue
            key = (work.dataset, fp, req.delta, req.params)
            hit = srv._cache_get(key)
            if hit is not None:
                req.cached = True
                srv._bump("cache_hits", 1)
                outcome[req.rid] = ("ok", hit)
                continue
            poison = srv._poisoned(self._qkey(req))
            if poison is not None:
                outcome[req.rid] = ("err", poison)
                continue
            params = dict(req.params)
            split = partition_reduce_params(req.delta, params)
            if split is None or not self.batching:
                outcome[req.rid] = self._serve_solo(handle, req, key, params)
                continue
            config, shared = split
            gkey = tuple(sorted(shared.items()))
            members = groups.setdefault(gkey, [])
            for cfg, _p, reqs in members:
                if cfg == config:          # in-window dedup: same config,
                    reqs.append(req)       # one engine slot
                    break
            else:
                members.append((config, params, [req]))

        for gkey, members in groups.items():
            self._serve_group(handle, dict(gkey), members, fp, outcome)

        results: List[Tuple[Any, Tuple[str, Any]]] = []
        for req in work.requests:
            req.timing.mark_done()
            req.latency_s = req.timing.service_s
            srv.metrics.observe(req.timing)
            srv.requests.append(req)
            results.append((req, outcome[req.rid]))
        return results

    # -- dispatch units ------------------------------------------------------

    @staticmethod
    def _qkey(req) -> tuple:
        """Quarantine/last-good key: the query config *without* the content
        fingerprint — a poisoned config stays poisoned across retries on the
        same content, and the slate clears when content changes."""
        return (req.dataset, req.delta, req.params, req.configs)

    def _serve_solo(self, handle, req, key, params) -> Tuple[str, Any]:
        """The single-flight path: one query, one engine run (warm repair when the
        handle knows a previous result) — for queries the stacked engine
        cannot express, and every query of a ``batching=False`` server."""
        srv = self.srv
        qkey = self._qkey(req)
        try:
            with obs.span("scheduler.dispatch", dataset=req.dataset, epoch=req.epoch,
                          delta=req.delta, kind="solo") as sp:
                result = self._attempt(
                    "dispatch", lambda: handle.reduce(req.delta, **params))
                sp.set(warm=handle.last_was_warm, prefix_kept=handle.last_prefix_kept)
        except BaseException as e:
            return self._dispatch_failed(qkey, e, qkey)
        srv._cache_put(key, result)
        srv._last_good_put(qkey, result)
        req.warm = handle.last_was_warm
        req.prefix_kept = handle.last_prefix_kept
        req.batch_size = 1
        srv._bump("warm" if req.warm else "cold", 1)
        srv._bump("engine_runs", 1)
        srv.metrics.observe_dispatch(1)
        return ("ok", result)

    def _serve_group(self, handle, shared: dict, members, fp,
                     outcome: Dict[int, Tuple[str, Any]]) -> None:
        """One stacked ``reduce_many`` dispatch for a shared-knob group of
        heterogeneous configs; results fan out to every deduped request.
        If the stacked dispatch exhausts its retries, the group degrades to
        per-member solo serves: one poisoned member costs its own
        requesters, never the whole group."""
        srv = self.srv
        if len(members) == 1:
            # a lone config gains nothing from stacking: keep the solo
            # warm-repair path (byte-identical either way — §3.8 parity)
            _cfg, params, reqs = members[0]
            lead = reqs[0]
            key = (lead.dataset, fp, lead.delta, lead.params)
            out = self._serve_solo(handle, lead, key, params)
            for req in reqs:
                req.warm = lead.warm
                req.prefix_kept = lead.prefix_kept
                req.batch_size = lead.batch_size
                outcome[req.rid] = out
            return
        # a canonical member order: the port's ensemble runner (and its
        # CUDA graph) is keyed on the ordered measures, so one set of
        # configs replays one graph whatever order its queries arrived in
        members = sorted(members, key=lambda mem: repr(sorted(mem[0].items())))
        queries = [(cfg["delta"], {k: v for k, v in cfg.items()
                                   if k != "delta"})
                   for cfg, _p, _r in members]
        n_queries = sum(len(reqs) for _c, _p, reqs in members)
        try:
            lead = members[0][2][0]
            with obs.span("scheduler.dispatch", dataset=lead.dataset, epoch=lead.epoch,
                          kind="stacked", configs=len(members), queries=n_queries) as sp:
                results, kept, was_warm = self._attempt(
                    "dispatch",
                    lambda: handle.reduce_many(queries, **shared))
                sp.set(warm=any(was_warm), prefix_kept=max(kept, default=0))
        except BaseException:
            # stacked path failed: serve members individually — each solo
            # serve brings its own retry/quarantine/stale handling
            for _cfg, params, reqs in members:
                lead = reqs[0]
                key = (lead.dataset, fp, lead.delta, lead.params)
                out = self._serve_solo(handle, lead, key, params)
                for req in reqs:
                    req.warm = lead.warm
                    req.prefix_kept = lead.prefix_kept
                    req.batch_size = lead.batch_size
                    outcome[req.rid] = out
            return
        srv._bump("engine_runs", 1)
        srv.metrics.observe_dispatch(n_queries)
        for (cfg, params, reqs), result, k, warm in zip(
                members, results, kept, was_warm):
            key = (reqs[0].dataset, fp, reqs[0].delta, reqs[0].params)
            srv._cache_put(key, result)
            srv._last_good_put(self._qkey(reqs[0]), result)
            srv._bump("warm" if warm else "cold", 1)
            for req in reqs:
                req.warm = warm
                req.prefix_kept = k
                req.batch_size = n_queries
                outcome[req.rid] = ("ok", result)

    def _serve_ensemble(self, handle, req, fp) -> Tuple[str, Any]:
        """Serve a ``query_ensemble`` grid: per-config cache probes, one
        stacked run for exactly the missing configs (DESIGN.md §3.8)."""
        srv = self.srv
        shared = dict(req.params)
        srv._bump("ensemble_queries", 1)
        srv._bump("ensemble_configs", len(req.configs))
        qkey = self._qkey(req)
        poison = srv._poisoned(qkey)
        if poison is not None:
            return ("err", poison)

        grid = [dict(items) for items in req.configs]
        keys = []
        for c in grid:
            delta = c.get("delta", "PR")
            params = {**shared,
                      **{k: v for k, v in c.items() if k != "delta"}}
            keys.append((req.dataset, fp, delta,
                         tuple(sorted(params.items()))))

        results: List[Optional[Any]] = []
        misses: List[int] = []
        for j, key in enumerate(keys):
            hit = srv._cache_get(key)
            if hit is not None:
                srv._bump("cache_hits", 1)
            else:
                misses.append(j)
            results.append(hit)
        if misses:
            try:
                with obs.span("scheduler.dispatch", dataset=req.dataset, epoch=req.epoch,
                              kind="ensemble", configs=len(misses), warm=False,
                              prefix_kept=0):
                    fresh = self._attempt(
                        "dispatch",
                        lambda: handle.reduce_ensemble(
                            [grid[j] for j in misses], **shared))
            except BaseException as e:
                return self._dispatch_failed(qkey, e, None)
            srv._bump("engine_runs", 1)
            srv.metrics.observe_dispatch(len(misses))
            for j, r in zip(misses, fresh):
                srv._cache_put(keys[j], r)
                results[j] = r
            srv._bump("cold", len(misses))
        req.cached = not misses
        req.batch_size = len(misses)
        return ("ok", results)
