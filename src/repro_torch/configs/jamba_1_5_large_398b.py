"""jamba-1.5-large-398b — hybrid Mamba+attention 7:1, MoE 16e top-2.

[arXiv:2403.19887; hf-verified] 72L, d=8192, 64H (GQA kv=8), d_ff=24576.
Attention layers carry a 32k sliding window in long-context serving (the
Mamba layers give the O(1)-state sub-quadratic path for long_500k).
MoE every other layer (16 experts top-2); dense MLP between.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab=65_536,
    n_experts=16,
    top_k=2,
    moe_d_ff=24576,
    moe_every=2,
    attn_every=8,            # 1 attention layer per 8 (1:7 interleave)
    ssm_d_state=16,
    ssm_d_conv=4,
    ssm_expand=2,
    window=32_768,
    sub_quadratic=True,
    note="Mamba+attn 1:7 interleave, MoE every other layer",
)
