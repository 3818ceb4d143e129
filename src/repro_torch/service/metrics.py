"""Request latency accounting + aggregate serving metrics (DESIGN.md §3.9).

Two layers, deliberately small:

* :class:`RequestTiming` — the per-request stamp triple every serving
  surface in the repo records: enqueue → start (admitted / batch formed) →
  done.  Both the reduct server's :class:`~repro_torch.service.ReduceRequest`
  and the LM engine's :class:`~repro_torch.serving.engine.Request` carry one, so
  "queue wait" and "service time" mean the same thing across subsystems.
* :class:`ServiceMetrics` — the aggregate view the multi-tenant scheduler
  feeds: bounded windows of wait/latency samples (p50/p99 without keeping
  every request alive), batch-occupancy accounting per engine dispatch,
  and monotonically increasing counters (dedup hits, admission rejects,
  engine runs) that tests assert exactly.

Everything here is host-side plain Python: no torch, no locks beyond what
callers provide (the scheduler serializes engine dispatches; merge threads
touch only counters, which are guarded by the server's cache lock).

Since DESIGN.md §3.11 the counters and latency samples are backed by an
:class:`repro_torch.obs.MetricsRegistry` — per instance, because tests and
benchmarks build many servers per process — so the same numbers that feed
``summary()`` also render on the Prometheus exposition.  ``summary()``
output is byte-compatible with the pre-registry version.

The port's copy of ``repro.service.metrics``: the same metric names, so the
two packages' expositions read alike.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Deque, Dict, List, Optional, Sequence

from ..obs.registry import CounterMap, MetricsRegistry

__all__ = ["RequestTiming", "ServiceMetrics", "percentile"]

# Bounded sample-window depth: enough for stable p99 estimates under the
# benchmark firehose, small enough to never dominate server memory.
_WINDOW = 4096


@dataclasses.dataclass
class RequestTiming:
    """The three stamps of one request's life (``time.perf_counter``).

    ``t_enqueue`` — entered the queue; ``t_start`` — picked up by the
    scheduler (admitted into a batch / prefill started); ``t_done`` —
    result ready.  Derived views: ``queue_wait_s`` (enqueue → start),
    ``service_s`` (start → done), ``latency_s`` (enqueue → done).
    """

    t_enqueue: float = 0.0
    t_start: float = 0.0
    t_done: float = 0.0

    def mark_enqueue(self) -> "RequestTiming":
        self.t_enqueue = time.perf_counter()
        return self

    def mark_start(self) -> "RequestTiming":
        self.t_start = time.perf_counter()
        return self

    def mark_done(self) -> "RequestTiming":
        self.t_done = time.perf_counter()
        return self

    @property
    def queue_wait_s(self) -> float:
        return max(self.t_start - self.t_enqueue, 0.0)

    @property
    def service_s(self) -> float:
        return max(self.t_done - self.t_start, 0.0)

    @property
    def latency_s(self) -> float:
        return max(self.t_done - self.t_enqueue, 0.0)


def percentile(values: Sequence[float], q: float) -> float:
    """Linear-interpolated percentile (``q`` in [0, 100]); 0.0 when empty."""
    if not values:
        return 0.0
    xs = sorted(values)
    if len(xs) == 1:
        return xs[0]
    pos = (len(xs) - 1) * (q / 100.0)
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    frac = pos - lo
    return xs[lo] * (1.0 - frac) + xs[hi] * frac


class ServiceMetrics:
    """Aggregate serving metrics: latency percentiles, occupancy, counters.

    ``observe(timing)`` records one completed request;
    ``observe_dispatch(n)`` records one engine dispatch serving ``n``
    queries (batch occupancy); counters are plain ``inc(name)`` bumps.
    ``summary()`` renders the whole thing as a flat dict for benchmarks,
    the CLI, and tests.

    Pass ``registry=`` to land the counters/histograms on a shared
    registry (the reduct server shares one with its ``stats``); by default
    each instance owns a private one.
    """

    def __init__(self, window: int = _WINDOW,
                 registry: Optional[MetricsRegistry] = None) -> None:
        self._waits: Deque[float] = collections.deque(maxlen=window)
        self._latencies: Deque[float] = collections.deque(maxlen=window)
        self._occupancies: Deque[int] = collections.deque(maxlen=window)
        self.registry = registry if registry is not None else MetricsRegistry()
        self.counters: Dict[str, int] = CounterMap(
            self.registry, prefix="plar_service_",
            initial=("completed", "engine_dispatches", "batched_queries",
                     "dedup_hits", "rejected"))
        self._h_wait = self.registry.histogram(
            "plar_service_queue_wait_seconds",
            "request queue wait (enqueue to scheduler pickup)")
        self._h_latency = self.registry.histogram(
            "plar_service_latency_seconds",
            "end-to-end request latency (enqueue to done)")
        self._g_occupancy = self.registry.gauge(
            "plar_service_last_batch_occupancy",
            "queries served by the most recent engine dispatch")
        self._t_first: Optional[float] = None
        self._t_last: Optional[float] = None

    # -- recording ----------------------------------------------------------

    def observe(self, timing: RequestTiming) -> None:
        self._waits.append(timing.queue_wait_s)
        self._latencies.append(timing.latency_s)
        self._h_wait.observe(timing.queue_wait_s)
        self._h_latency.observe(timing.latency_s)
        self.counters["completed"] += 1
        if self._t_first is None:
            self._t_first = timing.t_done
        self._t_last = timing.t_done

    def observe_dispatch(self, n_queries: int) -> None:
        """One engine dispatch that served ``n_queries`` batched queries."""
        self._occupancies.append(int(n_queries))
        self._g_occupancy.set(int(n_queries))
        self.counters["engine_dispatches"] += 1
        if n_queries > 1:
            self.counters["batched_queries"] += n_queries

    def inc(self, name: str, by: int = 1) -> None:
        self.counters[name] += by

    # -- views --------------------------------------------------------------

    @property
    def completed(self) -> int:
        return self.counters["completed"]

    def sustained_qps(self) -> float:
        """Completed queries per second over the observed completion span."""
        if self._t_first is None or self._t_last is None:
            return 0.0
        span = self._t_last - self._t_first
        done = self.counters["completed"]
        if span <= 0.0:
            return float(done)
        # first completion anchors the span, so it is not *inside* it
        return (done - 1) / span if done > 1 else float(done)

    def mean_occupancy(self) -> float:
        occ: List[int] = list(self._occupancies)
        return sum(occ) / len(occ) if occ else 0.0

    def summary(self) -> Dict[str, float]:
        out: Dict[str, float] = {
            "completed": self.counters["completed"],
            "engine_dispatches": self.counters["engine_dispatches"],
            "batched_queries": self.counters["batched_queries"],
            "dedup_hits": self.counters["dedup_hits"],
            "rejected": self.counters["rejected"],
            "qps_sustained": round(self.sustained_qps(), 2),
            "mean_batch_occupancy": round(self.mean_occupancy(), 2),
            "queue_wait_p50_s": round(percentile(list(self._waits), 50), 4),
            "queue_wait_p99_s": round(percentile(list(self._waits), 99), 4),
            "latency_p50_s": round(percentile(list(self._latencies), 50), 4),
            "latency_p99_s": round(percentile(list(self._latencies), 99), 4),
        }
        # carry through any extra counters callers bumped (engine_runs, ...)
        for k, v in self.counters.items():
            out.setdefault(k, v)
        return out
