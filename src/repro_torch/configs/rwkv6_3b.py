"""rwkv6-3b (Finch) — attention-free: 32L, d=2560, d_ff=8960, vocab=65536.

[arXiv:2404.05892; hf-verified] Data-dependent decay (LoRA), head_dim=64.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-3b",
    family="ssm",
    n_layers=32,
    d_model=2560,
    n_heads=0,
    n_kv_heads=0,
    d_ff=8960,
    vocab=65_536,
    rwkv_head_dim=64,
    rwkv_decay_lora=64,
    sub_quadratic=True,
    note="Finch — data-dependent decay; attention-free",
)
