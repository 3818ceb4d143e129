"""The yardstick of the mesh's collectives: the bytes a rank must receive
and the least time the card's NVLink can receive them in.

Peak of one NVIDIA H100 SXM (NVIDIA's data sheet): NVLink 4, 18 links of
25 GB/s each way, 450 GB/s received by a card.

A rank must receive, whatever algorithm the library runs (ring, tree or
NVLink SHARP, where the switch does the sums):

* all-reduce of ``S`` bytes (each rank holds ``S``, each ends with the
  sum): ``S`` — with the switch's sums a rank receives the summed ``S``
  once; a ring or a tree receives more;
* all-gather of ``S`` bytes in all (each rank holds ``S / n``, each ends
  with all ``S``): ``(n - 1) / n · S``, the other ranks' shards.

So no algorithm reads over 100% under this count.
"""
from __future__ import annotations

__all__ = ["NVLINK_BYTES_PER_S", "all_reduce_received", "all_gather_received",
           "nvlink_seconds"]

NVLINK_BYTES_PER_S = 18 * 25e9


def all_reduce_received(n_bytes: float) -> float:
    """Bytes a rank must receive in an all-reduce of ``n_bytes``."""
    return float(n_bytes)


def all_gather_received(n_bytes: float, n_ranks: int) -> float:
    """Bytes a rank must receive in an all-gather whose result is ``n_bytes``."""
    return (n_ranks - 1) / n_ranks * float(n_bytes)


def nvlink_seconds(n_bytes: float) -> float:
    """The least time one card's NVLink receives ``n_bytes`` in."""
    return n_bytes / NVLINK_BYTES_PER_S
