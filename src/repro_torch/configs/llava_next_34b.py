"""llava-next-34b — VLM backbone: 60L, d=7168, 56H (GQA kv=8), d_ff=20480.

[hf:llava-hf/llava-v1.6-mistral-7b-hf family; unverified]
Backbone only per the brief; the vision frontend is a STUB — input_specs()
provides precomputed anyres patch embeddings (5 tiles × 576 = 2880 prefix
positions, 1152-d SigLIP-class features) projected by one learned matrix.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="llava-next-34b",
    family="vlm",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=20480,
    vocab=64_000,
    frontend="vision",
    frontend_dim=1152,
    frontend_tokens=2880,   # anyres: 5 tiles × 576 patches
    note="anyres tiling; vision frontend stubbed",
)
