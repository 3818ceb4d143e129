"""The device guard: CUDA graph captures against device work on other threads.

The engine captures its body as a CUDA graph inside the first call of each
config (``core/engine.py``), in PyTorch's default ``global`` capture mode.
In that mode a call that is unsafe during a capture — a host sync such as
``int(t)`` or ``.cpu()`` of a device tensor, or a ``cudaMalloc`` — made by
*any* thread invalidates the capture.  The online service runs exactly such
work on other threads while an engine dispatch is in flight: coalescing
merges (``fold_chunk`` reads ``int(g.num)``), dataset builds, fingerprints
and checkpoint snapshots (``service/scheduler.py``, ``service/server.py``).

Each device therefore has one :class:`DeviceGuard`:

* :meth:`DeviceGuard.exclusive` — held by a capture.  It waits for the work
  that holds the guard shared to end and keeps new work out until the
  capture ends (a waiting capture has priority over new shared holders).
* :meth:`DeviceGuard.shared` — held by device work off the dispatch thread.
  Any number at once, and beside replays, which take nothing: merges keep
  overlapping an engine dispatch everywhere except during its capture.
  Shared holds nest on a thread.
* :attr:`DeviceGuard.dispatch` — a re-entrant lock that serializes engine
  dispatches on the device.  A runner replays into static buffers that
  every caller of its config shares, and a dispatch's own syncs would break
  another dispatch's capture; the service's handles take it around every
  reduction.

A thread that holds the guard shared and asks for it exclusively raises
``RuntimeError`` (it would wait on itself).  The guard is plain host
threading and works on every device; on the CPU nothing captures, so only
the shared and dispatch sides are ever contended there.
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, Tuple

import torch

__all__ = ["DeviceGuard", "device_guard"]


class DeviceGuard:
    """A reader–writer guard of one device (see the module docstring).

    ``capture_waits`` / ``capture_wait_s`` count the exclusive holds that
    had to wait for shared work to end, and ``shared_waits`` /
    ``shared_wait_s`` the shared holds that waited for a capture.
    """

    def __init__(self) -> None:
        self._cond = threading.Condition()
        self._readers = 0
        self._writer = None            # ident of the thread holding it exclusively
        self._writers_waiting = 0
        self._local = threading.local()
        self.dispatch = threading.RLock()
        self.capture_waits = 0
        self.capture_wait_s = 0.0
        self.shared_waits = 0
        self.shared_wait_s = 0.0

    def _depth(self) -> int:
        return getattr(self._local, "depth", 0)

    @contextlib.contextmanager
    def shared(self):
        depth = self._depth()
        if depth or self._writer == threading.get_ident():
            # nested, or inside this thread's own exclusive hold
            self._local.depth = depth + 1
            try:
                yield
            finally:
                self._local.depth = depth
            return
        with self._cond:
            if self._writer is not None or self._writers_waiting:
                t0 = time.perf_counter()
                while self._writer is not None or self._writers_waiting:
                    self._cond.wait()
                self.shared_waits += 1
                self.shared_wait_s += time.perf_counter() - t0
            self._readers += 1
        self._local.depth = 1
        try:
            yield
        finally:
            self._local.depth = 0
            with self._cond:
                self._readers -= 1
                if not self._readers:
                    self._cond.notify_all()

    @contextlib.contextmanager
    def exclusive(self):
        me = threading.get_ident()
        if self._depth():
            raise RuntimeError(
                "a thread that holds the device guard shared cannot take it "
                "exclusively (it would wait on itself)")
        if self._writer == me:
            yield
            return
        with self._cond:
            self._writers_waiting += 1
            t0 = time.perf_counter()
            waited = False
            try:
                while self._writer is not None or self._readers:
                    waited = True
                    self._cond.wait()
            finally:
                self._writers_waiting -= 1
            self._writer = me
            if waited:
                self.capture_waits += 1
                self.capture_wait_s += time.perf_counter() - t0
        try:
            yield
        finally:
            with self._cond:
                self._writer = None
                self._cond.notify_all()


_guards: Dict[Tuple[str, int], DeviceGuard] = {}
_guards_lock = threading.Lock()


def device_guard(device) -> DeviceGuard:
    """The one :class:`DeviceGuard` of ``device`` (an index-less ``cuda`` is card 0)."""
    dev = torch.device(device)
    key = (dev.type, dev.index or 0)
    with _guards_lock:
        guard = _guards.get(key)
        if guard is None:
            guard = _guards[key] = DeviceGuard()
        return guard
