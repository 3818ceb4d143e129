"""The card's chunked RWKV6 algebra in plain PyTorch against the JAX package.

``repro_torch.kernels.rwkv6.ref.rwkv6_chunked_ref`` is the plain version of
the prefill kernel's design (``csrc/rwkv6.cu``): chunks of L tokens, with
the intra-chunk matrix M and the state update built from running products
of the decays, never their ratios.  It is held against JAX's Pallas kernel
``rwkv6_scan`` (interpret mode, as the JAX tests run it) and its oracle
``rwkv6_ref`` at rtol = atol = 1e-4, the JAX tests' tolerance:

* at L ∈ {16, 32, 64} and T ∈ {1, 7, L − 1, L, L + 1, 100} (chunks that
  are ragged, whole, and a single token);
* with sigmoid decays, with the model's decays w = exp(−exp(z)), z over
  [−8, 4] (w down to ~1.8e-24, where a product over a chunk underflows to 0
  and the ratio form would give 0/0), and with w = 0 exactly;
* and chained: two calls with the carried state equal one call.
"""
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.rwkv6 import rwkv6_ref as j_ref
from repro.kernels.rwkv6 import rwkv6_scan as j_scan
from repro_torch.kernels.rwkv6 import rwkv6_chunked_ref, rwkv6_ref

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)
CHUNKS = [16, 32, 64]
B, H, D = 1, 2, 16


@functools.lru_cache(maxsize=None)
def _inputs(t, decay):
    rng = np.random.default_rng(t * 7 + len(decay))
    r, k, v = ((rng.standard_normal((B, H, t, D)) * 0.5).astype(np.float32) for _ in range(3))
    if decay == "sigmoid":
        w = 1.0 / (1.0 + np.exp(-rng.standard_normal((B, H, t, D))))
    elif decay == "model":      # models/rwkv.py: w = exp(-exp(w0 + lora))
        w = np.exp(-np.exp(rng.uniform(-8.0, 4.0, (B, H, t, D))))
    else:
        w = np.zeros((B, H, t, D))
    u = (rng.standard_normal((H, D)) * 0.5).astype(np.float32)
    s0 = (rng.standard_normal((B, H, D, D)) * 0.1).astype(np.float32)
    return r, k, v, w.astype(np.float32), u, s0


@functools.lru_cache(maxsize=None)
def _jax(t, decay):
    args = [jnp.asarray(a) for a in _inputs(t, decay)]
    o, s = j_scan(*args, chunk=16)
    o_r, s_r = j_ref(*args)
    return [np.asarray(x) for x in (o, s, o_r, s_r)]


def _chunked(args, chunk):
    o, s = rwkv6_chunked_ref(*(torch.from_numpy(a) for a in args), chunk=chunk)
    return o.numpy(), s.numpy()


@pytest.mark.parametrize("decay", ["sigmoid", "model"])
@pytest.mark.parametrize("t_of", ["1", "7", "L-1", "L", "L+1", "100"])
@pytest.mark.parametrize("chunk", CHUNKS)
def test_chunked_matches_jax(chunk, t_of, decay):
    t = {"1": 1, "7": 7, "L-1": chunk - 1, "L": chunk, "L+1": chunk + 1, "100": 100}[t_of]
    args = _inputs(t, decay)
    o, s = _chunked(args, chunk)
    assert np.isfinite(o).all() and np.isfinite(s).all()
    o_k, s_k, o_r, s_r = _jax(t, decay)
    for want_o, want_s in ((o_k, s_k), (o_r, s_r)):
        np.testing.assert_allclose(o, want_o, **TOL)
        np.testing.assert_allclose(s, want_s, **TOL)


@pytest.mark.parametrize("chunk", CHUNKS)
def test_chunked_with_zero_decay_forgets(chunk):
    args = _inputs(70, "zero")
    o, s = _chunked(args, chunk)
    o_k, s_k, _, _ = _jax(70, "zero")
    np.testing.assert_allclose(o, o_k, **TOL)
    np.testing.assert_allclose(s, s_k, **TOL)
    # w = 0 keeps only the last token's k vᵀ in the state
    r, k, v, w, u, s0 = args
    np.testing.assert_allclose(s, k[:, :, -1, :, None] * v[:, :, -1, None, :], **TOL)


@pytest.mark.parametrize("chunk", CHUNKS)
def test_chunked_state_chaining(chunk):
    """[0:45] then [45:100] with the carried state == the full run, in the
    port and (second half) in JAX."""
    r, k, v, w, u, s0 = _inputs(100, "model")
    cut = lambda a, lo, hi: np.ascontiguousarray(a[:, :, lo:hi])  # noqa: E731
    o1, s1 = _chunked((cut(r, 0, 45), cut(k, 0, 45), cut(v, 0, 45), cut(w, 0, 45), u, s0), chunk)
    o2, s2 = _chunked((cut(r, 45, 100), cut(k, 45, 100), cut(v, 45, 100), cut(w, 45, 100), u,
                       s1), chunk)
    o_full, s_full = _chunked((r, k, v, w, u, s0), chunk)
    np.testing.assert_allclose(np.concatenate([o1, o2], axis=2), o_full, **TOL)
    np.testing.assert_allclose(s2, s_full, **TOL)
    jo2, js2 = j_scan(*(jnp.asarray(a) for a in (cut(r, 45, 100), cut(k, 45, 100),
                                                 cut(v, 45, 100), cut(w, 45, 100), u, s1)),
                      chunk=16)
    np.testing.assert_allclose(o2, np.asarray(jo2), **TOL)
    np.testing.assert_allclose(s2, np.asarray(js2), **TOL)


def test_chunked_equals_the_token_loop_without_initial_state():
    r, k, v, w, u, _ = (torch.from_numpy(a) for a in _inputs(50, "sigmoid"))
    o, s = rwkv6_chunked_ref(r, k, v, w, u, chunk=16)
    o_r, s_r = rwkv6_ref(r, k, v, w, u)
    torch.testing.assert_close(o, o_r, **TOL)
    torch.testing.assert_close(s, s_r, **TOL)
