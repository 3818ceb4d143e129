"""Deterministic fault injection for the resilience layer (DESIGN.md §3.10).

A :class:`FaultPlan` is a *seeded, step-indexed* schedule of failures: each
fault names an injection **site** (``shard_drop``, ``merge``, ``dispatch``,
``checkpoint``) and the 0-based occurrence of that site at which it fires.
The plan is consulted at exact code points — the scheduler's merge and
dispatch attempts, the checkpointer's write, the sharded build/recovery
loop — so a test or benchmark can say "the 2nd engine dispatch fails, the
1st checkpoint write crashes, shard 1 dies after the build" and replay it
bit-for-bit.  Two plans built from the same spec (or the same seed) fire
identically; nothing here consults wall clock or global RNG state.

Spec grammar (the ``--fault-plan`` CLI flag)::

    SPEC    := FAULT ("," FAULT)*
    FAULT   := KIND "@" STEP [":" ARG] ["x" COUNT]
    KIND    := shard_drop | merge | dispatch | checkpoint

``shard_drop@0:1`` — drop shard 1 at the first shard-drop site;
``dispatch@2x3`` — fail dispatch occurrences 2, 3 and 4;
``merge@0,checkpoint@0`` — first merge and first checkpoint write fail.

Injected failures raise :class:`FaultInjected` (``transient=True`` by
default — the retry layer's recoverable class; ``!`` after the kind makes
it fatal, e.g. ``dispatch!@1``).

The port's copy of ``repro.service.faults``: the same grammar, the same
seeded plans (numpy's ``default_rng``) and the same ``faults.fired`` event
and counter, on the port's own :mod:`repro_torch.obs`.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch import obs

__all__ = ["FAULT_KINDS", "FaultInjected", "FaultSpec", "FaultPlan"]

FAULT_KINDS = ("shard_drop", "merge", "dispatch", "checkpoint")


class FaultInjected(RuntimeError):
    """The raw injected failure — what a real infrastructure fault would
    look like to the caller (NOT a ServiceError: the resilience layer is
    supposed to classify and absorb it, not hand it to clients)."""

    def __init__(self, kind: str, step: int, *, transient: bool = True):
        super().__init__(f"injected {kind} fault at site step {step}")
        self.kind = kind
        self.step = step
        self.transient = transient


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One scheduled fault: fire at site occurrences [step, step+count)."""

    kind: str
    step: int
    arg: Optional[int] = None   # kind-specific (shard_drop: which shard)
    count: int = 1
    transient: bool = True

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r} "
                f"(one of: {', '.join(FAULT_KINDS)})")
        if self.step < 0 or self.count < 1:
            raise ValueError(
                f"fault step must be ≥ 0 and count ≥ 1, got "
                f"step={self.step} count={self.count}")

    def covers(self, step: int) -> bool:
        return self.step <= step < self.step + self.count


class FaultPlan:
    """Step-indexed fault schedule with per-site occurrence counters.

    Thread-safe: sites are consulted from scheduler worker threads and the
    event loop alike; the counter advance is atomic so a plan fires each
    scheduled fault exactly once regardless of interleaving.
    """

    def __init__(self, specs: Tuple[FaultSpec, ...] = ()):
        self.specs: Tuple[FaultSpec, ...] = tuple(specs)
        self._counters: Dict[str, int] = {k: 0 for k in FAULT_KINDS}
        self._lock = threading.Lock()
        self.fired: List[Tuple[str, int]] = []   # (kind, step) audit log

    # -- construction --------------------------------------------------------

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        """Build a plan from the CLI grammar (module docstring)."""
        specs: List[FaultSpec] = []
        for part in filter(None, (p.strip() for p in spec.split(","))):
            if "@" not in part:
                raise ValueError(
                    f"bad fault {part!r}: expected KIND@STEP[:ARG][xCOUNT]")
            kind, _, rest = part.partition("@")
            kind = kind.strip()
            transient = not kind.endswith("!")
            kind = kind.rstrip("!")
            count = 1
            if "x" in rest:
                rest, _, cnt = rest.rpartition("x")
                count = int(cnt)
            arg: Optional[int] = None
            if ":" in rest:
                rest, _, a = rest.partition(":")
                arg = int(a)
            specs.append(FaultSpec(kind=kind, step=int(rest), arg=arg,
                                   count=count, transient=transient))
        return cls(tuple(specs))

    @classmethod
    def seeded(cls, seed: int, *, horizon: int = 8,
               kinds: Tuple[str, ...] = ("dispatch", "merge"),
               n_faults: int = 1) -> "FaultPlan":
        """A deterministic random plan: ``n_faults`` distinct occurrence
        indices per kind drawn from ``[0, horizon)`` by a seeded PRNG.
        Same seed → same plan, so chaos benchmarks are replayable."""
        rng = np.random.default_rng(seed)
        specs: List[FaultSpec] = []
        for kind in kinds:
            steps = rng.choice(horizon, size=min(n_faults, horizon),
                               replace=False)
            specs.extend(FaultSpec(kind=kind, step=int(s))
                         for s in sorted(steps))
        return cls(tuple(specs))

    # -- consultation (the injection sites call these) -----------------------

    def fire(self, kind: str) -> Optional[FaultSpec]:
        """Advance the site counter for ``kind``; return the matching spec
        if one is scheduled for this occurrence, else None."""
        if kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault site {kind!r}")
        hit: Optional[FaultSpec] = None
        with self._lock:
            step = self._counters[kind]
            self._counters[kind] += 1
            for spec in self.specs:
                if spec.kind == kind and spec.covers(step):
                    self.fired.append((kind, step))
                    hit = spec
                    break
        if hit is not None:  # flight-recorder postmortem, outside the lock
            obs.event("faults.fired", kind=kind, step=step,
                      transient=hit.transient)
            obs.counter("plar_faults_fired_total",
                        "fault-plan injections that fired").inc()
            obs.request_dump(f"fault-{kind}",
                             meta={"kind": kind, "step": step,
                                   "transient": hit.transient})
        return hit

    def inject(self, kind: str) -> None:
        """Raise :class:`FaultInjected` when a fault is scheduled here."""
        spec = self.fire(kind)
        if spec is not None:
            raise FaultInjected(kind, self.fired[-1][1],
                                transient=spec.transient)

    def reset(self) -> None:
        """Rewind every site counter (replay the same plan again)."""
        with self._lock:
            self._counters = {k: 0 for k in FAULT_KINDS}
            self.fired.clear()

    def __repr__(self) -> str:
        parts = [f"{s.kind}{'' if s.transient else '!'}@{s.step}"
                 + (f":{s.arg}" if s.arg is not None else "")
                 + (f"x{s.count}" if s.count != 1 else "")
                 for s in self.specs]
        return f"FaultPlan({','.join(parts)})"
