"""Flight-recorder tracing: spans, a bounded ring buffer, Perfetto export.

The whole PLAR stack — fused kernels, the device-resident engine, the
multi-tenant scheduler, lineage recovery — had *no* timeline visibility
before this module: `service/metrics.py` percentiles say how long a query
took, not where the time went.  This is the Spark event-log equivalent
(DESIGN.md §3.11): every engine dispatch, scheduler batching window,
coalescing merge, checkpoint write, and recovery refold records a **span**
(name + wall-clock interval + attributes) into a bounded in-memory ring
buffer — the *flight recorder* — which exports as Chrome-trace / Perfetto
JSON so one ``ui.perfetto.dev`` load renders the whole process on a single
timeline, worker threads as separate tracks.

Design constraints, in priority order:

* **Zero overhead when disabled.**  Tracing is off by default.  A disabled
  ``span()`` returns a process-wide singleton no-op context manager — no
  object allocation, no lock, no timestamp read — so instrumentation can
  live permanently in hot paths (asserted by tests/test_obs.py with
  ``tracemalloc`` and measured in benchmarks/obs_bench.py).  The
  *attribute* kwargs a call site passes are the only per-call cost.
* **Host-side only.**  Spans wrap dispatches (``block_until_ready`` and
  friends), never traced/jitted code: a span inside a ``lax.while_loop``
  body would either break tracing or record trace-time, not run-time.
* **Bounded.**  The ring buffer holds the last ``capacity`` records
  (default 65536); a week-long serving process keeps its most recent
  history and nothing else.  ``dump()`` serializes that tail next to the
  checkpoint directory when something goes wrong (quarantine, injected
  fault) — the postmortem artifact of a chaos run.
* **Thread-safe.**  Records append under one lock; span nesting is
  per-thread by construction (Perfetto reconstructs the stack from
  ``tid`` + intervals, so no explicit parent ids are needed).

Environment: ``REPRO_TRACE=1`` enables tracing at import;
``REPRO_TRACE_CAPACITY=N`` sizes the ring.
"""
from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Any, Deque, Dict, List, Optional, Tuple

__all__ = [
    "SpanRecord",
    "Tracer",
    "get_tracer",
    "span",
    "event",
    "enable",
    "disable",
    "set_dump_dir",
    "request_dump",
]

# Default ring depth: at ~120 bytes/record this is <10 MB resident, yet
# covers minutes of a busy serving process (the serve-bench firehose emits
# ~40 spans/query).
_DEFAULT_CAPACITY = 65536

# Flight-recorder dumps kept per directory (older ones are GC'd): a fault
# storm must not fill the checkpoint disk with dumps.
_MAX_DUMPS = 16


class SpanRecord:
    """One completed span or instant event (plain data, ``__slots__``).

    ``ph`` is the Chrome-trace phase: ``"X"`` (complete span with
    duration) or ``"i"`` (instant event).  Times are seconds on the
    tracer's ``perf_counter`` timeline, relative to :attr:`Tracer.epoch`
    (``epoch + t_start`` is a ``time.perf_counter()`` value); export
    converts to µs.
    """

    __slots__ = ("name", "cat", "ph", "t_start", "dur", "tid", "args")

    def __init__(self, name: str, cat: str, ph: str, t_start: float,
                 dur: float, tid: int, args: Optional[Dict[str, Any]]):
        self.name = name
        self.cat = cat
        self.ph = ph
        self.t_start = t_start
        self.dur = dur
        self.tid = tid
        self.args = args

    def __repr__(self) -> str:  # debugging aid only
        return (f"SpanRecord({self.name!r}, ph={self.ph!r}, "
                f"dur={self.dur * 1e3:.3f}ms, args={self.args!r})")


class _NullSpan:
    """The disabled-mode span: one process-wide instance, no state.

    Supports the full live-span surface (``set``, context manager) so call
    sites never branch on enablement themselves.
    """

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> "_NullSpan":
        return self


_NULL_SPAN = _NullSpan()


class _LiveSpan:
    """An open span: closes (and records) on ``__exit__``.

    ``set(**attrs)`` attaches attributes after entry — e.g. whether a
    dispatch hit a fresh compile is only known once it returns.
    """

    __slots__ = ("_tracer", "name", "_attrs", "_t0")

    def __init__(self, tracer: "Tracer", name: str,
                 attrs: Optional[Dict[str, Any]]):
        self._tracer = tracer
        self.name = name
        self._attrs = attrs
        self._t0 = 0.0

    def set(self, **attrs) -> "_LiveSpan":
        if self._attrs is None:
            self._attrs = attrs
        else:
            self._attrs.update(attrs)
        return self

    def __enter__(self) -> "_LiveSpan":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        t1 = time.perf_counter()
        if exc_type is not None:
            self.set(error=exc_type.__name__)
        self._tracer._record(
            self.name, "X", self._t0, t1 - self._t0, self._attrs)
        return False


def _category(name: str) -> str:
    """Subsystem category = the dotted prefix (``engine.dispatch`` →
    ``engine``): the Perfetto color/filter key and the ≥4-subsystems
    coverage check of benchmarks/obs_bench.py."""
    i = name.find(".")
    return name[:i] if i > 0 else name


class Tracer:
    """Thread-safe flight recorder: bounded ring of :class:`SpanRecord`.

    Disabled by default; ``enable()``/``disable()`` flip at runtime (the
    ``enabled`` read in :meth:`span` is a plain attribute load — the
    entirety of the disabled-mode cost).
    """

    def __init__(self, capacity: int = _DEFAULT_CAPACITY,
                 enabled: bool = False):
        self.enabled = bool(enabled)
        self._lock = threading.Lock()
        self._buf: Deque[SpanRecord] = collections.deque(
            maxlen=max(int(capacity), 1))
        self._epoch = time.perf_counter()
        self.dropped = 0          # records displaced by the ring bound
        self.recorded = 0         # total records ever appended

    # -- control -------------------------------------------------------------

    def enable(self, capacity: Optional[int] = None) -> "Tracer":
        if capacity is not None and capacity != self._buf.maxlen:
            with self._lock:
                self._buf = collections.deque(self._buf,
                                              maxlen=max(int(capacity), 1))
        self.enabled = True
        return self

    def disable(self) -> "Tracer":
        self.enabled = False
        return self

    @property
    def epoch(self) -> float:
        """The ``time.perf_counter()`` value every record's ``t_start`` is
        relative to: ``epoch + t_start`` lies on the process's
        ``perf_counter`` clock (fixed for the tracer's life)."""
        return self._epoch

    def clear(self) -> None:
        with self._lock:
            self._buf.clear()
            self.dropped = 0
            self.recorded = 0

    @property
    def capacity(self) -> int:
        return self._buf.maxlen or 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._buf)

    # -- recording -----------------------------------------------------------

    def span(self, name: str, **attrs):
        """Context manager timing one operation; no-op when disabled."""
        if not self.enabled:
            return _NULL_SPAN
        return _LiveSpan(self, name, attrs or None)

    def event(self, name: str, **attrs) -> None:
        """Instant record (retry fired, fault injected, quarantine, ...)."""
        if not self.enabled:
            return
        self._record(name, "i", time.perf_counter(), 0.0, attrs or None)

    def _record(self, name: str, ph: str, t0: float, dur: float,
                args: Optional[Dict[str, Any]]) -> None:
        rec = SpanRecord(name, _category(name), ph, t0 - self._epoch, dur,
                         threading.get_ident(), args)
        with self._lock:
            if len(self._buf) == self._buf.maxlen:
                self.dropped += 1
            self._buf.append(rec)
            self.recorded += 1

    # -- introspection / export ----------------------------------------------

    def records(self, last_n: Optional[int] = None) -> List[SpanRecord]:
        """A stable copy of the ring's tail (oldest → newest)."""
        with self._lock:
            out = list(self._buf)
        return out if last_n is None else out[-last_n:]

    def trace_events(self, last_n: Optional[int] = None) -> List[Dict]:
        """Chrome-trace event dicts (the ``traceEvents`` array)."""
        pid = os.getpid()
        events: List[Dict] = []
        for r in self.records(last_n):
            ev: Dict[str, Any] = {
                "name": r.name, "cat": r.cat, "ph": r.ph,
                "ts": round(r.t_start * 1e6, 3),
                "pid": pid, "tid": r.tid,
            }
            if r.ph == "X":
                ev["dur"] = round(r.dur * 1e6, 3)
            else:
                ev["s"] = "t"          # instant event, thread-scoped
            if r.args:
                ev["args"] = {k: _jsonable(v) for k, v in r.args.items()}
            events.append(ev)
        return events

    def export(self, path: str, last_n: Optional[int] = None,
               meta: Optional[Dict[str, Any]] = None) -> str:
        """Write Perfetto/Chrome-trace JSON; returns ``path``.

        Load at https://ui.perfetto.dev (or chrome://tracing).  ``meta``
        lands in the file's ``otherData`` — dump reason, fired faults, ...
        """
        doc = {
            "traceEvents": self.trace_events(last_n),
            "displayTimeUnit": "ms",
            "otherData": {
                "recorded": self.recorded,
                "dropped": self.dropped,
                "perf_counter_epoch_s": self._epoch,
                **(meta or {}),
            },
        }
        tmp = f"{path}.tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, path)
        return path


def _jsonable(v: Any) -> Any:
    """Span attributes must serialize: common scalars pass through, numpy
    scalars collapse via item(), everything else goes repr()."""
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    item = getattr(v, "item", None)
    if callable(item):
        try:
            return item()
        except (TypeError, ValueError):
            pass
    return repr(v)


# ---------------------------------------------------------------------------
# the process tracer + module-level conveniences (the instrumentation API)
# ---------------------------------------------------------------------------

_TRACER = Tracer(
    capacity=int(os.environ.get("REPRO_TRACE_CAPACITY", _DEFAULT_CAPACITY)),
    enabled=os.environ.get("REPRO_TRACE", "") not in ("", "0", "false"),
)


def get_tracer() -> Tracer:
    """The process-wide flight recorder."""
    return _TRACER


def span(name: str, **attrs):
    """``with span("engine.dispatch", dataset=...):`` — the one-liner every
    instrumentation point uses.  Returns the shared no-op when disabled."""
    if not _TRACER.enabled:
        return _NULL_SPAN
    return _LiveSpan(_TRACER, name, attrs or None)


def event(name: str, **attrs) -> None:
    if _TRACER.enabled:
        _TRACER._record(name, "i", time.perf_counter(), 0.0, attrs or None)


def enable(capacity: Optional[int] = None) -> Tracer:
    return _TRACER.enable(capacity)


def disable() -> Tracer:
    return _TRACER.disable()


# ---------------------------------------------------------------------------
# dump-on-failure: the flight recorder's reason to exist
# ---------------------------------------------------------------------------

_dump_state: Dict[str, Any] = {"dir": None, "seq": 0, "lock": threading.Lock()}


def set_dump_dir(path: Optional[str]) -> None:
    """Where :func:`request_dump` serializes the ring (``None`` disables).
    The server points this at its checkpoint directory, so postmortem
    traces land next to the state they explain."""
    _dump_state["dir"] = path


def request_dump(reason: str, last_n: Optional[int] = None,
                 meta: Optional[Dict[str, Any]] = None) -> Optional[str]:
    """Serialize the flight recorder's tail for postmortem analysis.

    Called at failure sites (query quarantined, fault plan fired).  A
    no-op — returning ``None`` — unless tracing is enabled *and* a dump
    directory is configured.  Keeps the newest :data:`_MAX_DUMPS` files.
    """
    d = _dump_state["dir"]
    if d is None or not _TRACER.enabled:
        return None
    safe = "".join(c if c.isalnum() or c in "-_." else "-" for c in reason)
    with _dump_state["lock"]:
        _dump_state["seq"] += 1
        seq = _dump_state["seq"]
    try:
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, f"flightrec-{seq:04d}-{safe[:64]}.json")
        _TRACER.export(path, last_n=last_n,
                       meta={"reason": reason, "unix_time": int(time.time()),
                             **(meta or {})})
        _gc_dumps(d)
        return path
    except OSError:
        return None  # a full disk must never take the failing path down too


def _gc_dumps(d: str) -> None:
    try:
        dumps = sorted(f for f in os.listdir(d)
                       if f.startswith("flightrec-") and f.endswith(".json"))
        for f in dumps[:-_MAX_DUMPS]:
            os.unlink(os.path.join(d, f))
    except OSError:
        pass
