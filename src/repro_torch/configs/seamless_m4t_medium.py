"""seamless-m4t-medium — enc-dec multimodal: 12+12L, d=1024, 16H, d_ff=4096.

[arXiv:2308.11596; hf-verified] Audio frontend STUBBED — input_specs()
provides precomputed frame embeddings (160-d fbank-stack class features).
Decode shapes run the decoder against the encoder memory; long_500k skipped
(full attention).
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-medium",
    family="audio",
    n_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab=256_206,
    enc_layers=12,
    dec_layers=12,
    frontend="audio",
    frontend_dim=160,
    note="enc-dec, multimodal; audio frontend stubbed",
)
