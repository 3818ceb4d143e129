"""Roofline terms and the card's figures: the port's counterpart of
``repro.launch.roofline``.

The one home of the GPU's constants.  :class:`DeviceSpec` holds them as one
frozen record:

* from ``torch.cuda.get_device_properties``: SMs, shared memory a block may
  opt in to and an SM holds, registers and threads an SM holds, L2 bytes;
* from a table keyed by the device name (NVIDIA's data sheets): device
  memory bytes/s, float32 (outside the tensor cores) and bf16 (tensor
  cores, dense) operations/s, and NVLink bytes/s each way.

:func:`device_spec` reads them for a CUDA device; for the CPU (and with no
device) it returns :data:`H100_SXM`, a fixed spec, so a model that ranks
with it is a pure function of its shapes on every machine.  The Θ kernels'
cost model (:mod:`repro_torch.kernels.contingency.model`) and
``chip_smoke.py``'s bounds both read their rates here.

Three terms per step, as in the JAX package:

    compute    = flops / peak ops/s of the operand type
    memory     = bytes / device memory bytes/s
    collective = wire bytes / NVLink bytes/s (each way)

``extrapolate`` and ``extrapolate_collectives`` carry the JAX package's
linear probe rule (``total(P) = p1 + (P - 1)·(p2 - p1)``) and
:func:`model_flops` its useful-work yardstick, over the port's
``ArchConfig``.  JAX's HLO-text parsers (``parse_collectives``,
``parse_convert_bytes``) have no counterpart here: they feed its
``dryrun.py`` from compiled HLO, and the port will count collectives from
``torch.distributed`` when it ports that launcher.
"""
from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import Dict, Optional

__all__ = [
    "DeviceSpec",
    "H100_SXM",
    "H200_SXM",
    "CollectiveStats",
    "device_spec",
    "extrapolate",
    "extrapolate_collectives",
    "model_flops",
    "roofline_terms",
    "PEAK_FLOPS",
    "PEAK_FLOPS_F32",
    "HBM_BW",
    "NVLINK_BW",
]


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

PEAK_FLOPS = H100_SXM.bf16_ops_per_s
PEAK_FLOPS_F32 = H100_SXM.f32_ops_per_s
HBM_BW = H100_SXM.hbm_bytes_per_s
NVLINK_BW = H100_SXM.nvlink_bytes_per_s


def device_spec(device=None) -> DeviceSpec:
    """The figures of ``device``: a CUDA device's own properties and the
    rates of its name, or :data:`H100_SXM` for the CPU and for ``None``.

    A CUDA card missing from the rate table raises: its rates are unknown,
    and a bound or a model built on another card's would be wrong.
    """
    import torch

    if device is None:
        return H100_SXM
    dev = torch.device(device)
    if dev.type != "cuda":
        return H100_SXM
    return _cuda_spec(torch.cuda.current_device() if dev.index is None else dev.index)


@lru_cache(maxsize=None)
def _cuda_spec(index: int) -> DeviceSpec:
    """Card ``index``'s spec, read once: the tile selector asks at every launch."""
    import torch

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


def roofline_terms(flops_dev: float, bytes_dev: float, wire_bytes_dev: float, *,
                   dtype: str = "bf16", spec: Optional[DeviceSpec] = None) -> dict:
    """Compute, memory and collective seconds on ``spec`` (default
    :data:`H100_SXM`), the dominant one, and the bound (their largest).

    ``dtype`` names the operations' type: ``"bf16"`` (tensor cores, as the
    JAX package's TPU figure) or ``"f32"`` (CUDA cores).
    """
    spec = H100_SXM if spec is None else spec
    compute = flops_dev / spec.peak_ops(dtype)
    memory = bytes_dev / spec.hbm_bytes_per_s
    collective = wire_bytes_dev / spec.nvlink_bytes_per_s
    dominant = max(
        [("compute", compute), ("memory", memory), ("collective", collective)],
        key=lambda kv: kv[1],
    )[0]
    return {
        "compute_s": compute,
        "memory_s": memory,
        "collective_s": collective,
        "dominant": dominant,
        "bound_s": max(compute, memory, collective),
    }


@dataclasses.dataclass
class CollectiveStats:
    counts: Dict[str, int]
    result_bytes: Dict[str, int]     # Σ result sizes per kind
    wire_bytes: Dict[str, float]     # ring-model per-device wire bytes per kind

    @property
    def total_wire_bytes(self) -> float:
        return sum(self.wire_bytes.values())

    def as_dict(self):
        return {"counts": self.counts, "result_bytes": self.result_bytes,
                "wire_bytes": self.wire_bytes,
                "total_wire_bytes": self.total_wire_bytes}


def extrapolate(p1: float, p2: float, n_periods: int) -> float:
    """total(P) = p1 + (P-1)·(p2-p1); clamps tiny negative diffs to 0."""
    delta = max(p2 - p1, 0.0)
    return p1 + (n_periods - 1) * delta


def extrapolate_collectives(s1: CollectiveStats, s2: CollectiveStats,
                            n_periods: int) -> Dict[str, float]:
    kinds = set(s1.wire_bytes) | set(s2.wire_bytes)
    return {k: extrapolate(s1.wire_bytes.get(k, 0.0), s2.wire_bytes.get(k, 0.0), n_periods)
            for k in kinds}


def model_flops(cfg, shape) -> float:
    """6·N_active·D for training; 2·N_active·D + attention reads for serving.

    Attention scores/values add 4·B·Hq·Dh·S_q·S_kv per attention layer
    (halved for causal).  The textbook MFU numerator, the JAX package's
    arithmetic over the port's ``ArchConfig``.
    """
    n_active = cfg.active_param_count()
    b, s = shape.global_batch, shape.seq_len
    kinds = cfg.block_kinds()
    n_attn = sum(1 for k in kinds if k == "attn")
    if cfg.is_encdec:
        n_attn = cfg.enc_layers + 2 * cfg.dec_layers

    if shape.kind == "train":
        if cfg.is_encdec:
            dec = s // 4
            tokens = b * (s + dec)
            attn = 4 * b * cfg.n_heads * cfg.hd * (
                cfg.enc_layers * s * s
                + cfg.dec_layers * dec * dec * 0.5
                + cfg.dec_layers * dec * s
            )
        else:
            tokens = b * s
            attn = 2 * b * cfg.n_heads * cfg.hd * n_attn * (
                min(s, cfg.window or s) * s
            )  # causal ⇒ ×1/2 of 4·S² (window caps the span)
        return 6.0 * n_active * tokens + 3.0 * attn

    if shape.kind == "prefill":
        tokens = b * s
        if cfg.is_encdec:
            attn = 4 * b * cfg.n_heads * cfg.hd * cfg.enc_layers * s * s
        else:
            attn = 2 * b * cfg.n_heads * cfg.hd * n_attn * min(s, cfg.window or s) * s
        return 2.0 * n_active * tokens + attn

    # decode: one token per sequence
    span = min(s, cfg.window or s)
    if cfg.is_encdec:
        attn = 4 * b * cfg.n_heads * cfg.hd * cfg.dec_layers * (s + 1)
        return 2.0 * n_active * b + attn
    attn = 4 * b * cfg.n_heads * cfg.hd * n_attn * span
    return 2.0 * n_active * b + attn
