"""The port's training attention options against the JAX package.

``flash_bwd``: the chunked stream with its hand-written streaming backward
(``flash_xla_attention``), at the four shapes of ``tests/test_flash_bwd.py``
(GQA, an unpadded and a padded length, non-causal, a sliding window) with
32-row chunks: its output and its gradients (of the same loss, Σ sin(o)/2)
against JAX's ``flash_xla_attention`` within 1e-4·max|JAX| and against the
port's plain attention's autograd.  ``attn_naive``: the S² einsum against
the plain version.  Both on the CPU, f32, inputs drawn with numpy.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.models.attention import flash_xla_attention as j_flash_xla_attention
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import attention_ref
from repro_torch.models import build_model
from repro_torch.models.attention import _naive_attention, flash_xla_attention

torch.set_num_threads(1)

SHAPES = [
    (2, 4, 2, 96, 32, True, None),
    (1, 2, 2, 100, 16, True, None),
    (1, 4, 1, 64, 32, False, None),
    (1, 4, 2, 128, 32, True, 40),
]


def _inputs(b, hq, hkv, s, dh):
    rng = np.random.default_rng(s * 7 + dh)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, hq, s, dh), (b, hkv, s, dh), (b, hkv, s, dh))]


def _close(got, want, what, rel=1e-4):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= rel * scale, (what, float(np.abs(got - want).max()))


def _port_grads(fn, arrays):
    ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
    o = fn(*ts)
    return o.detach(), torch.autograd.grad((torch.sin(o) * 0.5).sum(), ts)


@pytest.mark.parametrize("b,hq,hkv,s,dh,causal,window", SHAPES)
def test_flash_bwd_matches_jax(b, hq, hkv, s, dh, causal, window):
    arrays = _inputs(b, hq, hkv, s, dh)
    flash = lambda q, k, v: flash_xla_attention(  # noqa: E731
        q, k, v, causal=causal, window=window, q_chunk=32, kv_chunk=32)
    o, grads = _port_grads(flash, arrays)

    def j_loss(q, k, v):
        return jnp.sum(jnp.sin(j_flash_xla_attention(
            q, k, v, causal=causal, window=window, q_chunk=32, kv_chunk=32)) * 0.5)

    j_in = [jnp.asarray(a) for a in arrays]
    j_o = j_flash_xla_attention(*j_in, causal=causal, window=window, q_chunk=32, kv_chunk=32)
    _close(o, j_o, "output")
    for got, want, name in zip(grads, jax.grad(j_loss, argnums=(0, 1, 2))(*j_in), "qkv"):
        _close(got, want, f"d{name}")
    # and the port's own plain attention under autograd
    ref_o, ref_grads = _port_grads(
        lambda q, k, v: attention_ref(q, k, v, causal=causal, window=window), arrays)
    np.testing.assert_allclose(o, ref_o, rtol=2e-5, atol=2e-5)
    for got, want in zip(grads, ref_grads):
        np.testing.assert_allclose(got, want, rtol=5e-5, atol=5e-5)


@pytest.mark.parametrize("b,hq,hkv,s,dh,causal,window", SHAPES)
def test_naive_attention_matches_ref(b, hq, hkv, s, dh, causal, window):
    arrays = _inputs(b, hq, hkv, s, dh)
    naive = lambda q, k, v: _naive_attention(  # noqa: E731
        q, k, v, causal=causal, window=window, scale=dh ** -0.5)
    o, grads = _port_grads(naive, arrays)
    ref_o, ref_grads = _port_grads(
        lambda q, k, v: attention_ref(q, k, v, causal=causal, window=window), arrays)
    np.testing.assert_allclose(o, ref_o, rtol=2e-5, atol=2e-5)
    for got, want in zip(grads, ref_grads):
        np.testing.assert_allclose(got, want, rtol=5e-5, atol=5e-5)


def test_flash_bwd_config_path():
    """cfg.flash_bwd / attn_naive train with finite gradients and the
    default path's loss."""
    cfg = get_config("tinyllama-1.1b").reduced()
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (2, 24))),
             "labels": torch.from_numpy(rng.integers(0, cfg.vocab, (2, 24)))}
    losses = {}
    for option in (None, "flash_bwd", "attn_naive"):
        c = dataclasses.replace(cfg, **({option: True} if option else {}))
        model = build_model(c, device="cpu").requires_grad_(True)
        loss, _ = model.loss(batch)
        grads = torch.autograd.grad(loss, list(model.parameters()))
        assert all(bool(torch.isfinite(g).all()) for g in grads)
        losses[option] = float(loss.detach())
    assert abs(losses["flash_bwd"] - losses[None]) < 1e-5, losses
    assert abs(losses["attn_naive"] - losses[None]) < 1e-5, losses


def test_mha_matches_jax():
    """``mha`` by JAX's implementation names: the kernel's differentiable
    wrapper (its plain forward on the CPU) and the plain version, both
    equal to JAX's ``mha`` in interpret mode; an unknown name raises."""
    from repro.kernels.flash_attention import mha as j_mha
    from repro_torch.kernels.flash_attention import mha

    arrays = _inputs(1, 4, 2, 40, 32)
    want = j_mha(*[jnp.asarray(a) for a in arrays], causal=True, window=16)
    for impl in ("pallas", "xla"):
        o, grads = _port_grads(lambda q, k, v: mha(q, k, v, window=16, impl=impl), arrays)
        _close(o, want, impl)
        assert all(float(g.abs().max()) > 0 for g in grads), impl
    with pytest.raises(ValueError, match="unknown attention impl"):
        mha(*[torch.from_numpy(a) for a in arrays], impl="triton")
