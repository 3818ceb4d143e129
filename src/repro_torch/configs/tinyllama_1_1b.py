"""tinyllama-1.1b — llama2-arch small: 22L, d=2048, 32H (GQA kv=4), d_ff=5632.

[arXiv:2401.02385; hf-verified]
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="tinyllama-1.1b",
    family="dense",
    n_layers=22,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    head_dim=64,
    d_ff=5632,
    vocab=32_000,
    note="llama2-arch small",
)
