"""The yardstick's arithmetic: the card's published peaks and the bytes the
greedy loop's Θ evaluation needs.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at 700 W): 3.35 TB/s of
HBM3 and 67 TFLOP/s in float32 outside the tensor cores.

Θ(D|R∪{a}) for every remaining candidate ``a`` of one greedy iteration needs,
with ``G`` live granules and ``R`` candidates: each candidate's codes read
once (``4·G·R`` bytes at the int32 width the granular table holds them in),
the partition ids, decisions and weights read once (``12·G``) and one score
written per candidate (``4·R``).  Chunking, tiling and re-reads do not enter
the count: it is the work the inputs need, whatever implements it.
"""
from __future__ import annotations

from typing import Iterable

__all__ = ["HBM_BYTES_PER_S", "F32_FLOPS_PER_S", "theta_iteration_bytes",
           "theta_bytes", "remaining_per_iteration", "roofline_seconds"]

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12


def theta_iteration_bytes(g: int, r: int) -> int:
    """Bytes one iteration's candidate evaluation needs (``G`` granules, ``R`` candidates)."""
    return 4 * g * r + 12 * g + 4 * r


def remaining_per_iteration(n_attrs: int, n_forced: int, iterations: int) -> list:
    """Candidates still unselected at each greedy iteration, after ``n_forced``
    forced attributes (the core or a warm prefix)."""
    return [n_attrs - n_forced - i for i in range(iterations)]


def theta_bytes(g: int, remaining: Iterable[int]) -> int:
    """Bytes the Θ evaluation of a whole reduction needs."""
    return sum(theta_iteration_bytes(g, r) for r in remaining)


def roofline_seconds(n_bytes: float) -> float:
    """The least time the card's HBM can move ``n_bytes`` in."""
    return n_bytes / HBM_BYTES_PER_S
