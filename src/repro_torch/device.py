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
"""
from __future__ import annotations

import contextlib
from contextvars import ContextVar
from typing import Union

import torch

DeviceLike = Union[str, torch.device]

__all__ = ["DeviceLike", "MODEL_DEVICE", "modelling", "resolve_device"]

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
