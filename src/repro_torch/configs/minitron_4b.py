"""minitron-4b — pruned Nemotron: 32L, d=3072, 24H (GQA kv=8), d_ff=9216.

[arXiv:2407.14679; hf-verified]
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="minitron-4b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    head_dim=128,
    d_ff=9216,
    vocab=256_000,
    note="pruned nemotron",
)
