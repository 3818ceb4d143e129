"""The card's figures, the port's one home of the GPU's constants.

:class:`DeviceSpec` holds them as one frozen record:

* from ``torch.cuda.get_device_properties``: SMs, shared memory a block may
  opt in to and an SM holds, registers and threads an SM holds, L2 bytes;
* from a table keyed by the device name (NVIDIA's data sheets): device
  memory bytes/s, float32 (outside the tensor cores) and bf16 (tensor
  cores, dense) operations/s, and NVLink bytes/s each way.

:func:`device_spec` reads them for a CUDA device; for the CPU (and with no
device) it returns :data:`H100_SXM`, a fixed spec, so a model that ranks
with it is a pure function of its shapes on every machine.  The Θ kernels'
cost model and tile selector (``kernels/contingency/model.py``,
``autotune.py``) read their rates here, and so does
:mod:`repro_torch.launch.roofline`, which re-exports these names.  The
module imports torch alone: the kernels' import path (and so every
reduction that launches them) stays clear of ``repro_torch.launch`` and
of DTensor.
"""
from __future__ import annotations

import dataclasses
from functools import lru_cache

import torch

__all__ = ["DeviceSpec", "H100_SXM", "H200_SXM", "device_spec"]


@dataclasses.dataclass(frozen=True)
class DeviceSpec:
    """What one card offers the cost model and the bounds."""

    name: str
    sms: int
    smem_per_block: int        # bytes a block may opt in to (dynamic + static)
    smem_per_sm: int           # bytes an SM holds for its resident blocks
    regs_per_sm: int           # 32-bit registers an SM holds
    threads_per_sm: int
    l2_bytes: int
    hbm_bytes_per_s: float     # device memory
    f32_ops_per_s: float       # float32 outside the tensor cores
    bf16_ops_per_s: float      # bf16 tensor cores, dense
    nvlink_bytes_per_s: float  # to another card, each way
    threads_per_block: int = 1024
    blocks_per_sm: int = 32
    smem_reserved_per_block: int = 1024   # the runtime's share of each block's shared memory

    def peak_ops(self, dtype: str) -> float:
        if dtype == "f32":
            return self.f32_ops_per_s
        if dtype == "bf16":
            return self.bf16_ops_per_s
        raise ValueError(f"unknown operand type {dtype!r} (one of: f32, bf16)")


# NVIDIA's data sheets, SXM parts, dense rates at the 700 W limit.
H100_SXM = DeviceSpec(
    name="NVIDIA H100 SXM", sms=132, smem_per_block=232_448, smem_per_sm=233_472,
    regs_per_sm=65_536, threads_per_sm=2_048, l2_bytes=50 * 1024 * 1024,
    hbm_bytes_per_s=3.35e12, f32_ops_per_s=67e12, bf16_ops_per_s=989e12,
    nvlink_bytes_per_s=450e9)
H200_SXM = dataclasses.replace(H100_SXM, name="NVIDIA H200 SXM", hbm_bytes_per_s=4.8e12)

# Device-name table: the first entry whose every word is in the name.  An
# H100 that is not the SXM part (PCIe, NVL) has other rates: not listed.
_RATES = (
    (("H200",), H200_SXM),
    (("H100", "HBM3"), H100_SXM),
)

def device_spec(device=None) -> DeviceSpec:
    """The figures of ``device``: a CUDA device's own properties and the
    rates of its name, or :data:`H100_SXM` for the CPU and for ``None``.

    A CUDA card missing from the rate table raises: its rates are unknown,
    and a bound or a model built on another card's would be wrong.
    """
    if device is None:
        return H100_SXM
    dev = torch.device(device)
    if dev.type != "cuda":
        return H100_SXM
    return _cuda_spec(torch.cuda.current_device() if dev.index is None else dev.index)


@lru_cache(maxsize=None)
def _cuda_spec(index: int) -> DeviceSpec:
    """Card ``index``'s spec, read once: the tile selector asks at every launch."""
    props = torch.cuda.get_device_properties(index)
    name = props.name
    rates = next((spec for words, spec in _RATES if all(w in name for w in words)), None)
    if rates is None:
        raise ValueError(f"no rates for the card {name!r}: the roofline table lists "
                         f"{[spec.name for _, spec in _RATES]}")
    return dataclasses.replace(
        rates, name=name, sms=props.multi_processor_count,
        smem_per_block=getattr(props, "shared_memory_per_block_optin", rates.smem_per_block),
        smem_per_sm=getattr(props, "shared_memory_per_multiprocessor", rates.smem_per_sm),
        regs_per_sm=getattr(props, "regs_per_multiprocessor", rates.regs_per_sm),
        threads_per_sm=getattr(props, "max_threads_per_multi_processor", rates.threads_per_sm),
        l2_bytes=getattr(props, "L2_cache_size", rates.l2_bytes))
