"""Holding a run's answers against the plain reference.

Every number compared has a limit of its own (the cell's ``limits`` in
``workloads/<cell>.json``) and passes when it is at most its limit:

* ``granules_off`` — granules whose multiplicity differs between the
  program's granular table and the reference's (limit 0);
* ``core_off``, ``reduct_off`` — answers whose core, or whose reduct in its
  order, differs (limit 0);
* ``theta_gap`` — the widest gap of Θ(D|C) and of a Θ history entry,
  position by position over the length both histories have;
* ``unanswered`` — answers due in the window that never came (limit 0).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterable, List

import torch

from .plar import Answer, Granules, union_granules

__all__ = ["Check", "granules_off", "answer_gaps", "fold_gaps", "make_checks"]


@dataclasses.dataclass
class Check:
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


def granules_off(x, d, w, ref: Granules) -> int:
    """How many granules' multiplicities differ (``x, d, w``: the program's
    live granules, any order)."""
    dev = ref.x.device
    prog = Granules(x=torch.as_tensor(x, device=dev).to(torch.int32),
                    d=torch.as_tensor(d, device=dev).to(torch.int64),
                    w=torch.as_tensor(w, device=dev).to(torch.float64))
    _g, weights = union_granules([prog, ref])
    return int((weights[0] != weights[1]).sum())


def answer_gaps(prog: dict, ref: Answer) -> Dict[str, float]:
    """The numbers of one answer: ``prog`` carries the program's ``reduct``,
    ``core``, ``theta_full`` and ``theta_history``."""
    hist = list(prog["theta_history"])
    n = min(len(hist), len(ref.theta_history))
    gaps = [abs(float(a) - float(b)) for a, b in zip(hist[:n], ref.theta_history[:n])]
    gaps.append(abs(float(prog["theta_full"]) - ref.theta_full))
    return {
        "reduct_off": float(ref.off > 0 or list(prog["reduct"]) != list(ref.reduct)),
        "core_off": float(list(prog["core"]) != list(ref.core)),
        "theta_gap": max(gaps),
    }


def fold_gaps(rows: Iterable[Dict[str, float]]) -> Dict[str, float]:
    """Counts add up, gaps take the widest."""
    out: Dict[str, float] = {}
    for row in rows:
        for k, v in row.items():
            if math.isnan(v):
                v = math.inf
            out[k] = out.get(k, 0.0) + v if k.endswith("_off") else max(out.get(k, 0.0), v)
    return out


def make_checks(values: Dict[str, float], limits: Dict[str, float]) -> List[Check]:
    """One :class:`Check` a limit; a number with no reading fails."""
    return [Check(name, float(values.get(name, math.inf)), float(limit))
            for name, limit in limits.items()]
