"""Architecture registry: ``--arch <id>`` resolution + per-arch shape sets.

The port's copy of ``repro.configs`` (pure data).  Each assigned
architecture has its own config module; ``get_config`` maps the public arch
id to its :class:`repro_torch.models.config.ArchConfig`.  All ten resolve;
building a family the port does not run yet raises (``models.build_model``).
``cells()`` enumerates the assigned (arch × shape) grid, honoring the
brief's skips: ``long_500k`` only for sub-quadratic archs (SSM / hybrid).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from repro_torch.models.config import ArchConfig, SHAPES, ShapeConfig

from . import (
    gemma_2b,
    jamba_1_5_large_398b,
    kimi_k2_1t_a32b,
    llava_next_34b,
    minitron_4b,
    mistral_nemo_12b,
    qwen3_moe_235b_a22b,
    rwkv6_3b,
    seamless_m4t_medium,
    tinyllama_1_1b,
)

_REGISTRY: Dict[str, ArchConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (
        qwen3_moe_235b_a22b,
        kimi_k2_1t_a32b,
        minitron_4b,
        gemma_2b,
        mistral_nemo_12b,
        tinyllama_1_1b,
        llava_next_34b,
        jamba_1_5_large_398b,
        rwkv6_3b,
        seamless_m4t_medium,
    )
}

ARCH_IDS: List[str] = list(_REGISTRY)


def get_config(name: str) -> ArchConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_IDS}")
    return _REGISTRY[name]


def shape_applies(cfg: ArchConfig, shape: ShapeConfig) -> bool:
    """The brief's applicability rules (skips recorded in DESIGN.md)."""
    if shape.name == "long_500k":
        return cfg.sub_quadratic  # needs sub-quadratic attention
    return True


def cells() -> List[Tuple[str, str]]:
    """All assigned (arch, shape) dry-run cells (40 total incl. noted skips)."""
    out = []
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for shape in SHAPES.values():
            out.append((arch, shape.name))
    return out


def runnable_cells() -> List[Tuple[str, str]]:
    return [(a, s) for a, s in cells() if shape_applies(get_config(a), SHAPES[s])]
