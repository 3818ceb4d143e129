"""Small arithmetic the metric readers share."""
from __future__ import annotations

import math
import statistics
from typing import List, Optional, Sequence, Tuple

__all__ = ["ok_jobs", "job_intervals", "update_latencies", "nearest_rank", "median",
           "idle_pct", "span_seconds"]


def ok_jobs(run) -> list:
    return [j for j in run.record.get("jobs", []) if j["ok"]]


def job_intervals(run) -> List[Tuple[float, float]]:
    return [(j["t0"], j["t2"]) for j in ok_jobs(run)]


def update_latencies(run) -> List[float]:
    """Every update of the window; one that failed is infinitely late."""
    return [u["latency_s"] for u in run.record.get("updates", [])]


def nearest_rank(values: Sequence[float], q: float) -> Optional[float]:
    """The ``q`` quantile by nearest rank (``None`` without values)."""
    if not values:
        return None
    s = sorted(values)
    return s[max(0, math.ceil(q * len(s)) - 1)]


def median(values: Sequence[float]) -> Optional[float]:
    return statistics.median(values) if values else None


def idle_pct(run, intervals) -> Optional[float]:
    """Per cent of the intervals with nothing on the device (traced runs)."""
    total = sum(b - a for a, b in intervals)
    if not run.trace.traced or total <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy(intervals) / total)


def span_seconds(run, name: str) -> Optional[float]:
    """Seconds inside the program's span ``name``, a window update on average."""
    updates = run.record.get("updates", [])
    spans = [e - s for n, s, e in run.record.get("spans", []) if n == name]
    if not updates or not spans:
        return None
    return sum(spans) / len(updates)
