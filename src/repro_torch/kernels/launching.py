"""What every kernel wrapper of the port shares: the device rule and the stream.

* :func:`on_cpu` — all-CPU operands take the plain version; all operands on
  one CUDA device launch the kernel; anything else raises.  There is no
  fallback from the card to the plain version.
* :func:`stream` — PyTorch's current stream on a device, as the ``c_void_p``
  the C launch functions take.
"""
from __future__ import annotations

import torch

__all__ = ["on_cpu", "stream"]


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


def stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
