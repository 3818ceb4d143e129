"""kimi-k2-1t-a32b — 61L, d=7168, 64H (GQA kv=8), MoE 384e top-8 + 1 shared.

[arXiv:2501.kimi2 paper-table; unverified] Trillion-parameter MoE.  The brief
specifies GQA kv=8 (the real K2 uses MLA; we follow the brief's table).
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=2048,
    vocab=163_840,
    n_experts=384,
    top_k=8,
    moe_d_ff=2048,
    moe_every=1,
    n_shared_experts=1,
    rope_theta=50_000.0,
    note="trillion-param MoE; 384 experts top-8 + 1 shared",
)
