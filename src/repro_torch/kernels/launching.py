"""What every kernel wrapper of the port shares: the device rule, the stream
and the dry-run's kernel costs.

* :func:`on_cpu` — all-CPU operands take the plain version; all operands on
  one CUDA device launch the kernel; anything else raises.  There is no
  fallback from the card to the plain version.
* :func:`modelled` — all operands on ``meta``, the card's stand-in of the
  dry-run's counted cells (:func:`repro_torch.device.modelling`): the
  wrapper returns outputs of the kernel's shapes and dtypes (a shape-only
  twin), never the plain version, and counts the call in its ``MODELLED``
  counter, never in ``LAUNCHES``.
* :func:`note_kernel` — a kernel call's analytic operations and bytes (each
  input read once, each output written once), handed to every registered
  sink (:func:`add_sink`; ``launch.roofline.StepCounter`` is one).  A
  wrapper calls it for a launch on the card and for a twin alike, so a
  counted step counts the kernel the same both ways.  The sinks are a
  plain list, not a context variable: a CUDA backward (and the forward it
  recomputes under remat) runs on autograd's own thread.
* :func:`stream` — PyTorch's current stream on a device, as the ``c_void_p``
  the C launch functions take.
"""
from __future__ import annotations

from typing import Callable, List, Tuple

import torch

__all__ = ["add_sink", "modelled", "note_kernel", "on_cpu", "remove_sink", "stream"]

_SINKS: List[Callable[[str, float, float], None]] = []


def on_cpu(name: str, **tensors: torch.Tensor) -> bool:
    """True for all-CPU operands (plain version), False for all-CUDA (kernel)."""
    types = {t.device.type for t in tensors.values()}
    if types == {"cpu"}:
        return True
    if types != {"cuda"} or len({t.device for t in tensors.values()}) != 1:
        raise ValueError(
            f"{name}: operands must all lie on the CPU or all on one CUDA "
            f"device, got {[str(t.device) for t in tensors.values()]}")
    return False


def modelled(**tensors: torch.Tensor) -> bool:
    """True when every operand is a ``meta`` tensor (the modelled card)."""
    return all(t.device.type == "meta" for t in tensors.values())


def add_sink(sink: Callable[[str, float, float], None]) -> None:
    _SINKS.append(sink)


def remove_sink(sink: Callable[[str, float, float], None]) -> None:
    _SINKS.remove(sink)


def note_kernel(name: str, cost: Callable[[], Tuple[float, float]]) -> None:
    """Hand ``cost()`` (operations, bytes) to every sink; with no sink
    registered ``cost`` is not called, so a launch pays nothing for it."""
    if _SINKS:
        flops, nbytes = cost()
        for sink in list(_SINKS):
            sink(name, flops, nbytes)


def stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
