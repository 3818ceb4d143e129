"""Brute-force numpy oracle for the four measures, straight from the paper.

Implements Definitions 2.3–2.10 literally (explicit partitions as Python sets
of row indices), with none of the GrC/decomposition machinery.  Tests validate
every optimized path against this.  The port's own copy of
``repro.core.oracle`` (numpy only), so its examples need nothing of the JAX
package.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np

__all__ = ["partition", "theta_oracle", "reduct_oracle"]


def partition(x: np.ndarray, cols: Sequence[int]) -> List[np.ndarray]:
    """U/B as a list of row-index arrays (equivalence classes)."""
    if len(cols) == 0:
        return [np.arange(x.shape[0])]
    keys: Dict[Tuple, List[int]] = {}
    for i, row in enumerate(x[:, list(cols)]):
        keys.setdefault(tuple(row.tolist()), []).append(i)
    return [np.asarray(v) for v in keys.values()]


def theta_oracle(delta: str, x: np.ndarray, d: np.ndarray, cols: Sequence[int]) -> float:
    """Θ(D|B) from the raw definitions (Table 1, with Θ_PR = -γ)."""
    n = x.shape[0]
    classes = partition(x, cols)
    dec_values = np.unique(d)

    if delta == "PR":
        pos = 0
        for e in classes:
            if len(np.unique(d[e])) == 1:
                pos += len(e)
        return -pos / n

    total = 0.0
    for e in classes:
        ei = len(e)
        counts = np.asarray([(d[e] == dv).sum() for dv in dec_values], np.float64)
        if delta == "SCE":
            p_e = ei / n
            for c in counts:
                if c > 0:
                    total += -p_e * (c / ei) * math.log(c / ei)
        elif delta == "LCE":
            for c in counts:
                total += (c / n) * ((ei - c) / n)
        elif delta == "CCE":
            c2u = n * (n - 1) / 2.0
            term = (ei / n) * (ei * (ei - 1) / 2.0) / c2u
            for c in counts:
                term -= (c / n) * (c * (c - 1) / 2.0) / c2u
            total += term
        else:
            raise ValueError(delta)
    return float(total)


def reduct_oracle(
    delta: str,
    x: np.ndarray,
    d: np.ndarray,
    *,
    eps: float = 0.0,
    tol: float = 1e-6,
    tie_tol: float = 1e-5,
    compute_core: bool = True,
) -> List[int]:
    """Algorithm 1, literally: core via inner sig, then greedy argmin Θ.

    Uses the same tolerance-band lowest-index tie-breaking as the optimized
    implementation (see ``measures.argmin_with_ties``).
    """
    a_all = list(range(x.shape[1]))
    theta_c = theta_oracle(delta, x, d, a_all)
    core = []
    if compute_core:
        for a in a_all:
            rest = [b for b in a_all if b != a]
            if theta_oracle(delta, x, d, rest) - theta_c > eps + tie_tol:
                core.append(a)
    reduct = list(core)
    theta_r = theta_oracle(delta, x, d, reduct) if reduct else float("inf")
    while theta_r > theta_c + tol:
        remaining = [a for a in a_all if a not in reduct]
        if not remaining:
            break
        vals = np.asarray([theta_oracle(delta, x, d, reduct + [a]) for a in remaining])
        best = int(np.nonzero(vals <= vals.min() + tie_tol)[0][0])
        reduct.append(remaining[best])
        theta_r = theta_oracle(delta, x, d, reduct)
    return reduct
