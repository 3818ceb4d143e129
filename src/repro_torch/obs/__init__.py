"""Observability: flight-recorder tracing + process metrics (DESIGN.md §3.11).

The port's own copy of ``repro.obs`` (``registry.py`` verbatim; ``trace.py``
with one addition, the public ``Tracer.epoch`` that ties span times to
``time.perf_counter()``), so the PyTorch package imports nothing of the JAX
package while its spans and metrics keep the same names.  Two small host-side pieces
(stdlib only, safe to call from any layer, including module import time):

* :mod:`repro_torch.obs.trace` — the span API and bounded ring buffer
  (flight recorder) with Perfetto/Chrome-trace export and dump-on-failure.
  **Disabled by default, zero-overhead when disabled.**
* :mod:`repro_torch.obs.registry` — process-wide counter/gauge/histogram
  registry with a flat ``snapshot()`` and Prometheus text exposition.
  **Always on** (a lock + int add per bump).

The one-screen instrumentation idiom::

    from repro_torch import obs

    with obs.span("pipeline.fold_chunk", rows=n):
        ...
    obs.counter("plar_engine_runs_total").inc()

Enable tracing with ``obs.enable()`` (or ``REPRO_TRACE=1``), export with
``obs.get_tracer().export("trace.json")``, read at https://ui.perfetto.dev.
"""
from .registry import (
    DEFAULT_BUCKETS,
    Counter,
    CounterMap,
    Gauge,
    Histogram,
    MetricsRegistry,
    counter,
    gauge,
    get_registry,
    histogram,
    render_prometheus,
)
from .trace import (
    SpanRecord,
    Tracer,
    disable,
    enable,
    event,
    get_tracer,
    request_dump,
    set_dump_dir,
    span,
)

__all__ = [
    "DEFAULT_BUCKETS",
    "Counter",
    "CounterMap",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "SpanRecord",
    "Tracer",
    "counter",
    "disable",
    "enable",
    "event",
    "gauge",
    "get_registry",
    "get_tracer",
    "histogram",
    "render_prometheus",
    "request_dump",
    "set_dump_dir",
    "span",
]
