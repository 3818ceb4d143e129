"""Architecture + shape configuration for the model substrate.

The port's copy of ``repro.models.config``: one :class:`ArchConfig`
describes any of the 10 registered architectures (dense / MoE / hybrid /
SSM / VLM / audio enc-dec).  ``reduced()`` derives the CPU smoke-test config
of the same family (few layers, narrow, tiny vocab).  The dtype strings map
to torch dtypes through :func:`torch_dtype`.  The distribution fields
(``fsdp``, ``remat``, ...) are kept so a config reads the same in both
packages; the port's serving path does not read them.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def dtype_name(dtype: torch.dtype) -> str:
    """The config string of a torch dtype (``torch.bfloat16`` → ``"bfloat16"``)."""
    return {v: k for k, v in _DTYPES.items()}[dtype]


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config's dtype string (``"bfloat16"``, ...)."""
    if name not in _DTYPES:
        raise ValueError(f"unknown dtype {name!r}; one of {sorted(_DTYPES)}")
    return _DTYPES[name]


# ---------------------------------------------------------------------------
# Shapes (assigned input-shape set; identical across LM-family archs)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


# ---------------------------------------------------------------------------
# Architectures
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None   # default d_model // n_heads

    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0                # per-expert hidden width
    moe_every: int = 1               # MoE block every k-th layer (jamba: 2)
    n_shared_experts: int = 0        # always-on experts (kimi k2)
    capacity_factor: float = 1.25

    # --- hybrid (jamba): attention block every `attn_every` layers ---
    attn_every: int = 0              # 0 → all layers are attention
    # --- SSM (mamba) ---
    ssm_d_state: int = 16
    ssm_d_conv: int = 4
    ssm_expand: int = 2
    ssm_dt_rank: int = 0             # default ceil(d_model / 16)
    ssm_compute_dtype: str = "float32"  # §Perf: bf16 halves the scan tensors
    # --- rwkv6 ---
    rwkv_head_dim: int = 64
    rwkv_decay_lora: int = 64

    # --- encoder-decoder (seamless) ---
    enc_layers: int = 0              # 0 → decoder-only
    dec_layers: int = 0

    # --- frontends (stub) ---
    frontend: Optional[str] = None   # "vision" | "audio"
    frontend_dim: int = 0            # precomputed patch/frame feature width
    frontend_tokens: int = 0         # prefix positions fed by the frontend

    # --- misc ---
    activation: str = "swiglu"       # swiglu | geglu
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    embed_scale: bool = False        # gemma: hidden ×= sqrt(d_model)
    qk_norm: bool = False            # qwen3
    window: Optional[int] = None     # sliding-window size for long-context attn
    logit_softcap: Optional[float] = None

    # --- numerics / distribution ---
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    fsdp: bool = True                # ZeRO shard params/optimizer over 'data'
    remat: bool = True
    remat_policy: str = "nothing"    # nothing | dots (save matmul outputs)
    scan_unroll: bool = False        # unroll the layer scan (dry-run analysis)
    attn_naive: bool = False         # S² einsum attention (probe cost analysis)
    flash_bwd: bool = False          # §Perf: streaming custom-vjp attention bwd
    moe_weight_stationary: bool = False  # §Perf: serve-time MoE island keeps the
    # experts' 2-D (model × data) storage sharding and all-gathers the (few)
    # decode tokens instead of all-gathering expert weights every layer
    sub_quadratic: bool = False      # supports long_500k (SSM/hybrid/linear)

    note: str = ""

    # -- derived ----------------------------------------------------------
    @property
    def hd(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def dt_rank(self) -> int:
        return self.ssm_dt_rank or -(-self.d_model // 16)

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def is_encdec(self) -> bool:
        return self.enc_layers > 0

    @property
    def rwkv_heads(self) -> int:
        return self.d_model // self.rwkv_head_dim

    def block_kinds(self) -> Tuple[str, ...]:
        """Per-layer block kind: 'attn' | 'mamba' | 'rwkv'."""
        if self.family == "ssm":
            return ("rwkv",) * self.n_layers
        if self.family == "hybrid":
            # jamba: 1 attention layer per `attn_every` (paper: 1:7 interleave,
            # attention at position attn_every-1 of each period)
            kinds = []
            for i in range(self.n_layers):
                kinds.append("attn" if (i % self.attn_every) == self.attn_every - 1 else "mamba")
            return tuple(kinds)
        return ("attn",) * self.n_layers

    def layer_is_moe(self, i: int) -> bool:
        return self.n_experts > 0 and (i % self.moe_every) == self.moe_every - 1

    def param_count(self) -> int:
        """Total parameters (embedding + blocks), analytic."""
        d, hd = self.d_model, self.hd
        total = self.vocab * d  # embed
        if not self.tie_embeddings:
            total += self.vocab * d
        n_blocks = self.n_layers if not self.is_encdec else self.enc_layers + self.dec_layers
        for i in range(n_blocks):
            kind = self.block_kinds()[i % self.n_layers] if not self.is_encdec else "attn"
            if kind == "attn":
                total += d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd + self.n_heads * hd * d
            elif kind == "mamba":
                di, ds, r = self.ssm_d_inner, self.ssm_d_state, self.dt_rank
                total += d * 2 * di + di * self.ssm_d_conv + di * (r + 2 * ds) + r * di + di * ds + di + di * d
            elif kind == "rwkv":
                total += 5 * d * d + d * d  # r,k,v,g,o + w-lora approx
                total += 2 * d * self.d_ff  # channel mix
            if kind != "rwkv":
                if self.layer_is_moe(i):
                    e, fe = self.n_experts, self.moe_d_ff
                    total += d * e  # router
                    total += e * 3 * d * fe
                    total += self.n_shared_experts * 3 * d * fe
                else:
                    mult = 3 if self.activation in ("swiglu", "geglu") else 2
                    total += mult * d * self.d_ff
            total += 2 * d  # norms
        return total

    def active_param_count(self) -> int:
        """Activated parameters per token (MoE counts top_k experts only)."""
        if self.n_experts == 0:
            return self.param_count()
        d = self.d_model
        total = self.param_count()
        n_moe = sum(1 for i in range(self.n_layers) if self.layer_is_moe(i))
        inactive = n_moe * (self.n_experts - self.top_k) * 3 * d * self.moe_d_ff
        return total - inactive

    def dtype(self) -> torch.dtype:
        return torch_dtype(self.param_dtype)

    def reduced(self) -> "ArchConfig":
        """Same-family tiny config for CPU smoke tests."""
        changes = dict(
            n_layers=min(self.n_layers, 4),
            d_model=128,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads > 0 else 0,
            head_dim=32,
            d_ff=256,
            vocab=512,
            param_dtype="float32",
            compute_dtype="float32",
            remat=False,
            note=f"reduced smoke config of {self.name}",
        )
        if self.n_experts:
            changes.update(n_experts=4, top_k=2, moe_d_ff=64)
        if self.attn_every:
            changes.update(attn_every=2, n_layers=4)
        if self.family == "ssm":
            changes.update(rwkv_head_dim=32, rwkv_decay_lora=16, d_ff=224)
        if self.is_encdec:
            changes.update(enc_layers=2, dec_layers=2, n_layers=2)
        if self.frontend:
            changes.update(frontend_dim=64, frontend_tokens=8)
        if self.ssm_dt_rank:
            changes.update(ssm_dt_rank=8)
        return dataclasses.replace(self, **changes)
