"""Typed exception hierarchy for the reduct service (DESIGN.md §3.10).

Every failure the serving tier can hand a caller derives from
:class:`ServiceError`, so clients can catch the whole family — or match a
specific, actionable subtype — instead of pattern-matching ad-hoc
``RuntimeError`` strings.  ``ServiceError`` subclasses ``RuntimeError`` so
pre-hierarchy callers keep working unchanged.

The port's copy of ``repro.service.errors``, class for class.  Kept
dependency-free (no torch/numpy/asyncio imports): the hierarchy is
importable from anywhere — checkpoint restore paths, CLI entry points —
without dragging the serving stack along.
"""
from __future__ import annotations

__all__ = [
    "ServiceError",
    "ServerOverloaded",
    "ServerStopped",
    "QueryPoisoned",
    "ShardLost",
    "CheckpointCorrupt",
]


class ServiceError(RuntimeError):
    """Base of every typed service failure."""


class ServerOverloaded(ServiceError):
    """Raised by ``query``/``query_ensemble`` when the bounded request
    queue is full: the submit fails fast instead of growing the queue
    unboundedly (admission control, DESIGN.md §3.9)."""


class ServerStopped(ServiceError):
    """The server is stopping (or stopped): queued-but-unstarted requests
    fail fast with this instead of hanging on futures whose work will
    never run."""


class QueryPoisoned(ServiceError):
    """A query config that failed ``quarantine_after`` consecutive engine
    dispatches is quarantined: followers get this typed error immediately
    instead of re-running (and re-failing) the dispatch or wedging a shared
    dedup future.  ``cause`` carries the original failure; the quarantine
    clears when the dataset's content changes (a merge may fix it)."""

    def __init__(self, message: str, *, cause: BaseException = None,
                 failures: int = 0):
        super().__init__(message)
        self.cause = cause
        self.failures = failures


class ShardLost(ServiceError):
    """A data shard's device-resident granularity is gone (host death,
    evicted buffer, injected fault).  Recoverable: re-fold the shard from
    its :class:`~repro_torch.core.recovery.ShardLineage` (DESIGN.md §3.10)."""

    def __init__(self, message: str, *, shard_index: int = -1):
        super().__init__(message)
        self.shard_index = shard_index


class CheckpointCorrupt(ServiceError):
    """A checkpoint explicitly asked for is unreadable (truncated npz,
    invalid manifest).  Auto-selecting restores skip+warn past corrupt
    steps instead of raising this (``train/checkpoint.py``)."""
