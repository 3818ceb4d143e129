"""mistral-nemo-12b — 40L, d=5120, 32H (GQA kv=8), d_ff=14336, 128k ctx.

[hf:mistralai/Mistral-Nemo-Base-2407; hf-verified] rope_theta=1M for 128k.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="mistral-nemo-12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab=131_072,
    rope_theta=1_000_000.0,
    note="128k context",
)
