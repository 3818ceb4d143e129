"""Online attribute-reduction service (DESIGN.md §3.7/§3.9/§3.10).

Turns the batch reproduction into a stateful subsystem: a device-resident
granularity absorbs row-batch deltas through the §3.6 monoid merge, and
reducts are repaired by warm-starting the §3.5 selection engine from the
previous result instead of recomputing from an empty reduct.  The serving
tier is multi-tenant: a scheduler batches compatible concurrent queries
into stacked engine dispatches, deduplicates identical in-flight queries,
and bounds the queue with fail-fast admission control.

The resilience layer (§3.10) makes the service survive the failures a
long-lived deployment actually sees: shard lineage + re-fold recovery
(core/recovery.py), durable DatasetHandle checkpoints (checkpoint.py),
retry/quarantine/stale-degradation around dispatches (scheduler.py), a
typed :class:`ServiceError` hierarchy (errors.py), and a deterministic
fault-injection harness (faults.py).

The port's ``repro.service``: the same names, modules, spans and counters,
on the port's engine.  Datasets live on the server's ``device`` (default
``cuda``); the device guard (``core/guard.py``) keeps merges and other
off-thread device work out of the engine's CUDA graph captures.
"""
from .checkpoint import ServiceCheckpointer, handle_from_state, handle_to_state
from .errors import (
    CheckpointCorrupt,
    QueryPoisoned,
    ServerOverloaded,
    ServerStopped,
    ServiceError,
    ShardLost,
)
from .faults import FaultInjected, FaultPlan, FaultSpec
from .metrics import RequestTiming, ServiceMetrics, percentile
from .scheduler import RetryPolicy, Scheduler
from .server import ReduceRequest, ReductServer
from .state import (
    DatasetHandle,
    granularity_fingerprint,
    repair_reduce,
    repair_reduce_many,
    valid_prefix_len,
)

__all__ = [
    "CheckpointCorrupt",
    "DatasetHandle",
    "FaultInjected",
    "FaultPlan",
    "FaultSpec",
    "QueryPoisoned",
    "ReduceRequest",
    "ReductServer",
    "RequestTiming",
    "RetryPolicy",
    "Scheduler",
    "ServerOverloaded",
    "ServerStopped",
    "ServiceCheckpointer",
    "ServiceError",
    "ServiceMetrics",
    "ShardLost",
    "granularity_fingerprint",
    "handle_from_state",
    "handle_to_state",
    "percentile",
    "repair_reduce",
    "repair_reduce_many",
    "valid_prefix_len",
]
