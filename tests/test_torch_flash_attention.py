"""The port's flash-attention wrapper against the JAX package's kernel.

On the CPU the wrapper runs its kernel's plain version
(``repro_torch/kernels/flash_attention/ref.py``); the JAX side runs the
Pallas kernel in interpret mode, as the JAX tests do, and its jnp oracle
``attention_ref``.  Inputs are made from a seed with numpy and handed to
both.  Shapes are the JAX tests' (``tests/test_kernel_flash_attention.py``):
GQA, MQA, sq < skv, window 48, non-causal, Dh 256, sq = 1 at the JAX
kernel's 64 x 64 blocks, and a 200-row causal case at each of its four block
shapes.  Tolerances are the JAX tests': rtol = atol = 2e-5 in f32, 0.05 in
bf16.

The card's bf16 path runs the tensor-core kernel, whose numerics
``attention_tc_ref`` models (p split into two bf16 parts for the product
with v, f32 sums).  That model is held against the JAX kernel in bf16 under
the per-element gate the card tests use, |d| <= 1e-2·|jax| + 2e-3: one
output rounding.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.flash_attention import attention_ref as j_ref
from repro.kernels.flash_attention import flash_attention as j_flash
from repro_torch.kernels.flash_attention import (attention_ref, attention_tc_ref,
                                                flash_attention, ops)

torch.set_num_threads(1)

SHAPES = [  # b, hq, hkv, sq, skv, dh, causal, window
    (2, 4, 2, 128, 128, 64, True, None),    # GQA 2:1
    (1, 8, 1, 192, 192, 64, True, None),    # MQA
    (2, 4, 4, 96, 160, 32, True, None),     # chunked prefill: sq < skv
    (1, 4, 2, 256, 256, 64, True, 48),      # sliding window
    (1, 2, 2, 64, 64, 128, False, None),    # bidirectional
    (1, 2, 1, 64, 64, 256, True, None),     # head_dim 256
    (1, 4, 4, 1, 160, 64, True, None),      # single-token decode
]


def _qkv(seed, b, hq, hkv, sq, skv, dh):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, sq, dh)).astype(np.float32)
    k = rng.standard_normal((b, hkv, skv, dh)).astype(np.float32)
    v = rng.standard_normal((b, hkv, skv, dh)).astype(np.float32)
    return q, k, v


def _port(q, k, v, **kw):
    return flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                           **kw).numpy()


@pytest.mark.parametrize("b,hq,hkv,sq,skv,dh,causal,window", SHAPES)
def test_flash_matches_jax(b, hq, hkv, sq, skv, dh, causal, window):
    q, k, v = _qkv(b * 100 + sq, b, hq, hkv, sq, skv, dh)
    got = _port(q, k, v, causal=causal, window=window)
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    want_kernel = np.asarray(j_flash(jq, jk, jv, causal=causal, window=window, bq=64, bkv=64))
    want_ref = np.asarray(j_ref(jq, jk, jv, causal=causal, window=window))
    np.testing.assert_allclose(got, want_kernel, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, want_ref, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("bq,bkv", [(32, 32), (64, 128), (128, 64), (256, 256)])
def test_flash_matches_jax_at_each_block_shape(bq, bkv):
    q, k, v = _qkv(6, 1, 4, 2, 200, 200, 64)
    got = _port(q, k, v, causal=True)
    want = np.asarray(j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                              bq=bq, bkv=bkv))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_flash_bf16_matches_jax():
    q, k, v = _qkv(5, 1, 4, 2, 128, 128, 64)
    jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    want = np.asarray(j_flash(jq, jk, jv, causal=True, bq=64, bkv=64), np.float32)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = flash_attention(tq, tk, tv, causal=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0.05, atol=0.05)


def test_fully_masked_rows_give_zero():
    """sq > skv, causal: the first sq - skv queries see no key; both
    packages write 0 there (the l clamp at 1e-30)."""
    q, k, v = _qkv(11, 1, 2, 2, 48, 32, 32)
    got = _port(q, k, v, causal=True)
    want = np.asarray(j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                              bq=16, bkv=16))
    assert np.all(got[:, :, :16] == 0) and np.all(want[:, :, :16] == 0)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_cpu_wrapper_is_the_plain_version_and_counts_nothing():
    q, k, v = (torch.from_numpy(a) for a in _qkv(3, 1, 4, 2, 40, 40, 32))
    ops.reset_launch_counts()
    got = flash_attention(q, k, v, causal=True, window=16)
    assert torch.equal(got, attention_ref(q, k, v, causal=True, window=16))
    assert ops.launch_counts() == {"flash_attention": 0, "flash_attention_tc": 0}


def test_wrapper_rejects_mixed_devices_and_bad_window():
    q = torch.zeros((1, 2, 8, 32))
    with pytest.raises(ValueError, match="CPU or all on one CUDA"):
        flash_attention(q, q.to("meta"), q)
    with pytest.raises(ValueError, match="window must be positive"):
        flash_attention(q, q, q, window=0)


@pytest.mark.parametrize("b,hq,hkv,sq,skv,dh,causal,window", SHAPES)
def test_tensor_core_numerics_model_matches_jax_bf16(b, hq, hkv, sq, skv, dh, causal, window):
    """The tensor-core kernel's arithmetic (bf16 q, k, v; S in f32; p as
    hi + lo bf16 parts for P·V; f32 online softmax over 64-key tiles) is
    within one bf16 output rounding of the JAX kernel, element by element."""
    q, k, v = _qkv(b * 10 + sq + dh, b, hq, hkv, sq, skv, dh)
    jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    want = np.asarray(j_flash(jq, jk, jv, causal=causal, window=window, bq=64, bkv=64),
                      np.float32)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = attention_tc_ref(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == torch.bfloat16
    diff = np.abs(got.float().numpy() - want)
    assert np.all(diff <= 1e-2 * np.abs(want) + 2e-3), float(diff.max())


def test_tensor_core_numerics_model_keeps_fully_masked_rows_zero():
    """sq > skv, causal: rows that see no key write exactly 0, as JAX does."""
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in _qkv(12, 1, 2, 1, 100, 36, 64))
    got = attention_tc_ref(q, k, v, causal=True)
    assert torch.all(got[:, :, :64] == 0)
    diff = (got.float() - attention_ref(q, k, v, causal=True).float()).abs()
    assert torch.all(diff <= 1e-2 * attention_ref(q, k, v, causal=True).float().abs() + 2e-3)
