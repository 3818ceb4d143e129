"""The port's RWKV6 wrapper against the JAX package's kernel.

On the CPU the wrapper runs its kernel's plain version
(``repro_torch/kernels/rwkv6/ref.py``); the JAX side runs the Pallas kernel
``rwkv6_scan`` in interpret mode, as the JAX tests do, and its oracle
``rwkv6_ref``.  Inputs are made from a seed with numpy and handed to both.
Shapes and chunks are the JAX tests' (``tests/test_kernel_rwkv6.py``); the
port has no chunk axis, so it is held against JAX at each of JAX's chunk
sizes.  Tolerance rtol = atol = 1e-4, as the JAX tests use.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.rwkv6 import rwkv6_ref as j_ref
from repro.kernels.rwkv6 import rwkv6_scan as j_scan
from repro_torch.kernels.rwkv6 import ops, rwkv6, rwkv6_ref
from repro_torch.kernels.rwkv6.ops import chunk_split, column_split

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)


def _inputs(seed, b, h, t, d):
    rng = np.random.default_rng(seed)
    r = (rng.standard_normal((b, h, t, d)) * 0.5).astype(np.float32)
    k = (rng.standard_normal((b, h, t, d)) * 0.5).astype(np.float32)
    v = (rng.standard_normal((b, h, t, d)) * 0.5).astype(np.float32)
    w = (1.0 / (1.0 + np.exp(-rng.standard_normal((b, h, t, d))))).astype(np.float32)
    u = (rng.standard_normal((h, d)) * 0.5).astype(np.float32)
    s0 = (rng.standard_normal((b, h, d, d)) * 0.1).astype(np.float32)
    return r, k, v, w, u, s0


def _port(*arrays):
    o, s = rwkv6(*(torch.from_numpy(a) for a in arrays))
    return o.numpy(), s.numpy()


def _jax(*arrays, chunk):
    o, s = j_scan(*(jnp.asarray(a) for a in arrays), chunk=chunk)
    return np.asarray(o), np.asarray(s)


@pytest.mark.parametrize(
    "b,h,t,d,chunk",
    [
        (2, 2, 64, 16, 16),
        (1, 3, 128, 32, 32),
        (2, 1, 33, 8, 16),      # T not a chunk multiple
        (1, 2, 256, 64, 128),   # production head_dim
        (1, 1, 7, 4, 8),        # T < chunk
    ],
)
def test_rwkv6_matches_jax(b, h, t, d, chunk):
    args = _inputs(t * 31 + d, b, h, t, d)
    o, s = _port(*args)
    o_k, s_k = _jax(*args, chunk=chunk)
    o_r, s_r = (np.asarray(a) for a in j_ref(*(jnp.asarray(a) for a in args)))
    for want_o, want_s in ((o_k, s_k), (o_r, s_r)):
        np.testing.assert_allclose(o, want_o, **TOL)
        np.testing.assert_allclose(s, want_s, **TOL)


@pytest.fixture(scope="module")
def chunk_inputs():
    args = _inputs(9, 1, 2, 128, 16)
    return args, _port(*args)


@pytest.mark.parametrize("chunk", [8, 16, 64, 128])
def test_rwkv6_matches_jax_at_each_chunk(chunk_inputs, chunk):
    args, (o, s) = chunk_inputs
    o_k, s_k = _jax(*args, chunk=chunk)
    np.testing.assert_allclose(o, o_k, **TOL)
    np.testing.assert_allclose(s, s_k, **TOL)


def test_rwkv6_state_chaining_matches_jax():
    """[0:T/2] then [T/2:T] with the carried state == the full run, in both
    packages: the invariant decode relies on."""
    r, k, v, w, u, s0 = _inputs(10, 1, 2, 64, 16)
    o_full, s_full = _port(r, k, v, w, u, s0)
    half = 32
    cut = lambda a, lo, hi: np.ascontiguousarray(a[:, :, lo:hi])  # noqa: E731
    o1, s1 = _port(cut(r, 0, half), cut(k, 0, half), cut(v, 0, half), cut(w, 0, half), u, s0)
    o2, s2 = _port(cut(r, half, 64), cut(k, half, 64), cut(v, half, 64), cut(w, half, 64), u, s1)
    np.testing.assert_allclose(o_full[:, :, :half], o1, **TOL)
    np.testing.assert_allclose(o_full[:, :, half:], o2, **TOL)
    np.testing.assert_allclose(s_full, s2, **TOL)
    jo1, js1 = _jax(cut(r, 0, half), cut(k, 0, half), cut(v, 0, half), cut(w, 0, half), u, s0,
                    chunk=16)
    jo2, js2 = _jax(cut(r, half, 64), cut(k, half, 64), cut(v, half, 64), cut(w, half, 64), u,
                    js1, chunk=16)
    np.testing.assert_allclose(o2, jo2, **TOL)
    np.testing.assert_allclose(s2, js2, **TOL)


def test_rwkv6_decode_steps_match_jax():
    """T = 1 calls (the decode path) chained over 5 tokens."""
    r, k, v, w, u, s0 = _inputs(12, 2, 3, 5, 16)
    s_t, s_j = s0, s0
    for i in range(5):
        step = [np.ascontiguousarray(a[:, :, i:i + 1]) for a in (r, k, v, w)]
        o_t, s_t = _port(*step, u, s_t)
        o_j, s_j = _jax(*step, u, s_j, chunk=1)
        np.testing.assert_allclose(o_t, o_j, **TOL)
        np.testing.assert_allclose(s_t, s_j, **TOL)


def test_rwkv6_zero_decay_forgets():
    r, k, v, w, u, s0 = _inputs(12, 1, 1, 8, 4)
    w0, z = np.zeros_like(w), np.zeros_like(s0)
    o, _ = _port(r, k, v, w0, u, z)
    o_j, _ = _jax(r, k, v, w0, u, z, chunk=8)
    np.testing.assert_allclose(o, o_j, rtol=1e-5, atol=1e-5)


def test_cpu_wrapper_is_the_plain_version_and_counts_nothing():
    args = [torch.from_numpy(a) for a in _inputs(4, 1, 2, 9, 8)]
    ops.reset_launch_counts()
    o, s = rwkv6(*args)
    o_r, s_r = rwkv6_ref(*args)
    assert torch.equal(o, o_r) and torch.equal(s, s_r)
    assert ops.launch_counts() == {"rwkv6": 0, "rwkv6_decode": 0, "rwkv6_chunked": 0}
    o0, s0 = rwkv6(*args[:5])                      # no initial state: zeros
    o1, _ = rwkv6_ref(*args[:5], torch.zeros_like(args[5]))
    assert torch.equal(o0, o1) and s0.shape == args[5].shape


def test_column_split_fills_the_card():
    assert column_split(40, 64, 132) == 4          # one rwkv6-3b request
    assert column_split(160, 64, 132) == 1         # four requests
    assert column_split(80, 64, 132) == 2
    assert column_split(1, 16, 132) == 1           # keeps >= 16 columns a CTA


def test_chunk_split_keeps_one_cta_an_sm():
    assert chunk_split(40, 64, 132) == 2           # one rwkv6-3b request: 80 CTAs
    assert chunk_split(160, 64, 132) == 1          # four requests
    assert chunk_split(20, 64, 132) == 4
    assert chunk_split(1, 16, 132) == 1            # keeps >= 16 columns a CTA


def test_wrapper_rejects_mixed_devices():
    args = [torch.from_numpy(a) for a in _inputs(4, 1, 2, 3, 8)]
    with pytest.raises(ValueError, match="CPU or all on one CUDA"):
        rwkv6(args[0].to("meta"), *args[1:])
