"""gemma-2b — 18L, d=2048, 8H MQA (kv=1), GeGLU d_ff=16384, head_dim=256.

[arXiv:2403.08295; hf-verified] Tied embeddings, sqrt(d_model) embed scale.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="gemma-2b",
    family="dense",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab=256_000,
    activation="geglu",
    tie_embeddings=True,
    embed_scale=True,
    note="GeGLU, head_dim=256, MQA",
)
