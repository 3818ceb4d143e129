"""Request latency stamps: the port's ``repro.service.metrics.RequestTiming``.

:class:`RequestTiming` is the per-request stamp triple every serving surface
records: enqueue → start (admitted / prefill started) → done.  The LM
engine's :class:`~repro_torch.serving.engine.Request` carries one.  The
aggregate ``ServiceMetrics`` of the reduct service comes with the service
tier (ROADMAP).  Host-side plain Python.
"""
from __future__ import annotations

import dataclasses
import time

__all__ = ["RequestTiming"]


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
