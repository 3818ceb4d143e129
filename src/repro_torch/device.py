"""The device rule of the port's entry points.

``device="cuda"`` (the default everywhere) means the card: if PyTorch sees no
CUDA device, the call raises instead of falling back to the CPU.  Only an
explicit ``device="cpu"`` runs on the CPU — the plain-PyTorch path the CPU
tests take.

:func:`modelling` is the one exception, for the dry-run's counted cells
(``launch/dryrun.py``): inside it ``device="cuda"`` resolves to PyTorch's
``meta`` device, so a model is built at full size with uninitialised leaves
that hold no memory, and a step runs on shapes alone.  Outside it a card
is needed as before.  The card's stand-in is ``meta``, not fake ``cuda``
tensors: a CPU build of PyTorch has no CUDA device guard, and autograd and
Python indexing ask for one on every ``cuda`` tensor, fake or not.  The
kernel wrappers treat meta operands as the card's
(:func:`repro_torch.kernels.launching.modelled`): a shape-only twin of the
kernel, never the plain version.

:func:`to_host`, :func:`host_int` and :func:`host_float` are the reduction's
and the service's device→host reads: each waits for the device's queued
work, so each is counted, per thread (:func:`host_reads`, which spans read
into their ``host_reads`` attribute) and in the process registry's
``plar_host_reads_total`` (served on ``/metrics``).
"""
from __future__ import annotations

import contextlib
import threading
from contextvars import ContextVar
from typing import Union

import torch

from repro_torch import obs

DeviceLike = Union[str, torch.device]

__all__ = ["DeviceLike", "MODEL_DEVICE", "host_float", "host_int", "host_reads",
           "modelling", "resolve_device", "to_host"]

MODEL_DEVICE = torch.device("meta")      # the card's stand-in inside :func:`modelling`
_MODELLING: ContextVar[bool] = ContextVar("repro_torch_modelling", default=False)


@contextlib.contextmanager
def modelling():
    """Resolve ``"cuda"`` to :data:`MODEL_DEVICE` for the block (see the
    module doc); nests, and restores the rule on exit."""
    token = _MODELLING.set(True)
    try:
        yield MODEL_DEVICE
    finally:
        _MODELLING.reset(token)


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """Validate ``device`` and return it as a :class:`torch.device`."""
    dev = torch.device(device)
    if _MODELLING.get() and dev.type in ("cuda", "meta"):
        return MODEL_DEVICE
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r} (one of: cuda, cpu)")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} was asked for but torch.cuda.is_available() "
            "is False; pass device='cpu' to run on the CPU")
    return dev


class _Reads(threading.local):
    n = 0


_READS = _Reads()
_HOST_READS = obs.counter(
    "plar_host_reads_total",
    "device-to-host reads of the reduction and the reduct service (each waits for the device)")


def host_reads() -> int:
    """The device→host reads this thread has made through this module."""
    return _READS.n


def _count() -> None:
    _READS.n += 1
    _HOST_READS.inc()


def to_host(t: torch.Tensor) -> torch.Tensor:
    """``t.cpu()``, counted as one host read."""
    _count()
    return t.cpu()


def host_int(t: torch.Tensor) -> int:
    """``int(t)`` of a one-element tensor, counted as one host read."""
    _count()
    return int(t)


def host_float(t: torch.Tensor) -> float:
    """``float(t)`` of a one-element tensor, counted as one host read."""
    _count()
    return float(t)
