"""The traced window: device activity from ``torch.profiler`` on the card.

The profiler records the device's operations only (CUDA activity: kernels,
copies, fills), never the host's ops, so a traced window costs the host
little.  The records stay in memory, as arrays; only the numbers read from
them are printed.

Host and device clocks are tied by marks: :meth:`Trace.mark` launches one
tiny spin kernel (``torch.cuda._sleep``, which the program never calls) at a
known host time while the device is idle, and the least device-minus-host
offset over the marks maps any host interval onto the device timeline (to
within a launch's latency, some microseconds).  The profiler loses a mark
now and then (two of a hundred on the card); a lost mark pairs with nothing
and changes nothing.

The arithmetic is ``repro_torch.launch.profile_serve``'s: the busy time of
a set of intervals is the length of their union.
"""
from __future__ import annotations

import bisect
import contextlib
import re
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["Ops", "Trace", "top_device_ops", "idle_gaps"]

MARK_KERNEL = "spin_kernel"
_MARK_CYCLES = 1000
_NAME_CHARS = 120


class Ops:
    """Device operations: start and end (device seconds) and a name index,
    sorted by start."""

    def __init__(self, starts=(), ends=(), ids=(), names: Sequence[str] = ()):
        order = np.argsort(np.asarray(starts, np.float64), kind="stable")
        self.starts = np.asarray(starts, np.float64)[order]
        self.ends = np.asarray(ends, np.float64)[order]
        self.ids = np.asarray(ids, np.int64)[order]
        self.names = list(names)
        self._longest = float((self.ends - self.starts).max()) if len(order) else 0.0

    def __len__(self) -> int:
        return len(self.starts)

    def clip(self, lo: float, hi: float):
        """Starts, ends and name indices of the operations overlapping
        ``[lo, hi]``, cut to it (still sorted by start)."""
        i = int(np.searchsorted(self.starts, lo - self._longest, side="left"))
        j = int(np.searchsorted(self.starts, hi, side="left"))
        s, e, ids = self.starts[i:j], self.ends[i:j], self.ids[i:j]
        keep = e > lo
        return np.maximum(s[keep], lo), np.minimum(e[keep], hi), ids[keep]

    def busy(self, lo: float, hi: float) -> float:
        """Seconds of ``[lo, hi]`` with at least one operation running."""
        s, e, _ = self.clip(lo, hi)
        if not len(s):
            return 0.0
        before = np.concatenate(([lo], np.maximum.accumulate(e)[:-1]))
        return float(np.maximum(e - np.maximum(s, before), 0.0).sum())

    def gaps(self, lo: float, hi: float) -> List[Tuple[float, float]]:
        """The stretches of ``[lo, hi]`` with nothing running."""
        s, e, _ = self.clip(lo, hi)
        if not len(s):
            return [(lo, hi)]
        reach = np.maximum.accumulate(e)
        before = np.concatenate(([lo], reach[:-1]))
        idle = s > before
        out = list(zip(before[idle].tolist(), s[idle].tolist()))
        if hi > reach[-1]:
            out.append((float(reach[-1]), hi))
        return out

    def seconds(self, lo: float, hi: float, pattern: Optional[str] = None) -> np.ndarray:
        """Device seconds by name index inside ``[lo, hi]`` (only names
        matching ``pattern``, where given)."""
        s, e, ids = self.clip(lo, hi)
        out = np.bincount(ids, weights=e - s, minlength=len(self.names))
        if pattern is not None:
            rx = re.compile(pattern)
            out = out * np.array([bool(rx.search(n)) for n in self.names], bool)
        return out


def top_device_ops(ops: Ops, windows: Sequence[Tuple[float, float]], top: int = 10):
    """``[[name, seconds], ...]``: device time by operation name inside
    ``windows`` (device-clock seconds), most first."""
    total = sum((ops.seconds(lo, hi) for lo, hi in windows), np.zeros(len(ops.names)))
    ranked = np.argsort(-total, kind="stable")[:top]
    return [[ops.names[i][:_NAME_CHARS], float(total[i])] for i in ranked if total[i] > 0]


def idle_gaps(ops: Ops, windows, phases, top: int = 10):
    """``[[phase, seconds], ...]``: the longest stretches inside ``windows``
    with nothing on the device, each named by the innermost host phase
    (device-clock ``(name, start, end)``) around its middle."""
    gaps = [g for lo, hi in windows for g in ops.gaps(lo, hi)]
    out = []
    for s, e in sorted(gaps, key=lambda g: -(g[1] - g[0]))[:top]:
        mid = 0.5 * (s + e)
        around = [(pe - ps, name) for name, ps, pe in phases if ps <= mid <= pe]
        out.append([min(around)[1] if around else "other", e - s])
    return out


def _tie_clocks(dev_marks: Sequence[float], host_marks: Sequence[float],
                within: float = 1e-3) -> float:
    """The device-minus-host offset that pairs the most marks to within
    ``within`` seconds, refined to the least paired difference (the mark
    that waited least for its launch)."""
    if not dev_marks:
        raise RuntimeError("trace: no mark reached the device timeline")
    hosts = sorted(host_marks)

    def paired(guess: float) -> List[float]:
        out = []
        for d in dev_marks:
            i = bisect.bisect_left(hosts, d - guess - within)
            if i < len(hosts) and abs(d - hosts[i] - guess) < within:
                out.append(d - hosts[i])
        return out
    best = max((paired(dev_marks[0] - h) for h in hosts[:64]), key=len)
    return min(best)


class Trace:
    """Marks, host phases and (when ``enabled``) the device's operations."""

    def __init__(self, enabled: bool, device: torch.device):
        self.enabled = bool(enabled) and device.type == "cuda"
        self.marks: List[float] = []
        self.phases: List[Tuple[str, float, float]] = []
        self.ops = Ops()
        self.found_marks = 0
        self.read_s: dict = {}
        self._offset: Optional[float] = None
        self._prof = None

    def start(self) -> None:
        if self.enabled:
            self._prof = torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA])
            self._prof.start()

    def mark(self) -> float:
        """A host time that the device timeline can find again (while the
        profiler records; else only the host time)."""
        t = time.perf_counter()
        if self._prof is not None:
            torch.cuda._sleep(_MARK_CYCLES)
            self.marks.append(t)
        return t

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.phases.append((name, t0, time.perf_counter()))

    def stop(self) -> None:
        """End the profile and read the device's operations out of it."""
        if self._prof is None:
            return
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        self._prof.stop()
        t1 = time.perf_counter()
        cuda = torch.autograd.DeviceType.CUDA
        index: dict = {}
        starts, durs, ids, marks = [], [], [], []
        for e in self._prof.profiler.kineto_results.events():
            if e.device_type() != cuda:
                continue
            name = e.name()
            if MARK_KERNEL in name:
                marks.append(e.start_ns() * 1e-9)
                continue
            starts.append(e.start_ns())
            durs.append(e.duration_ns())
            ids.append(index.setdefault(name, len(index)))
        self._prof = None
        t2 = time.perf_counter()
        s = np.asarray(starts, np.float64) * 1e-9
        self.ops = Ops(s, s + np.asarray(durs, np.float64) * 1e-9, ids, list(index))
        self._offset = _tie_clocks(sorted(marks), self.marks)
        self.found_marks = len(marks)
        self.read_s = {"stop": t1 - t0, "events": t2 - t1, "arrays": time.perf_counter() - t2}

    @property
    def profiling(self) -> bool:
        """Whether the profiler records now."""
        return self._prof is not None

    @property
    def traced(self) -> bool:
        return self._offset is not None

    def dev(self, host_t: float) -> float:
        return host_t + self._offset

    def windows(self, host_intervals) -> List[Tuple[float, float]]:
        return [(self.dev(a), self.dev(b)) for a, b in host_intervals]

    def busy(self, host_intervals) -> float:
        """Seconds with an operation on the device inside the intervals."""
        return sum(self.ops.busy(lo, hi) for lo, hi in self.windows(host_intervals))

    def kernel_seconds(self, pattern: str, host_intervals) -> float:
        """Device seconds of the operations whose name matches ``pattern``."""
        return float(sum(self.ops.seconds(lo, hi, pattern).sum()
                         for lo, hi in self.windows(host_intervals)))

    def dev_phases(self, extra: Sequence[Tuple[str, float, float]] = ()):
        return [(n, self.dev(a), self.dev(b)) for n, a, b in list(self.phases) + list(extra)]
