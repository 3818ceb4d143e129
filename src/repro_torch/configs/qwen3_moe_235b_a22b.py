"""qwen3-moe-235b-a22b — 94L, d=4096, 64H (GQA kv=4), MoE 128e top-8.

[hf:Qwen/Qwen3-30B-A3B scaled per brief; hf-verified family]
Every layer is MoE (no dense interleave, no shared expert); qk-norm per Qwen3.
d_ff=1536 is the per-expert width.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    head_dim=128,
    d_ff=1536,            # unused (all layers MoE); kept for reference
    vocab=151_936,
    n_experts=128,
    top_k=8,
    moe_d_ff=1536,
    moe_every=1,
    qk_norm=True,
    rope_theta=1_000_000.0,
    note="128 experts top-8; qk-norm; GQA 64/4",
)
