"""The kernel wrappers take JAX's keyword arguments.

``rwkv6(impl=...)`` has JAX's meaning (``"pallas"`` the kernel, its plain
version on the CPU; ``"xla"`` ``rwkv6_ref``; anything else a
``ValueError``), and the TPU tiling and interpreter knobs (``chunk``,
``interpret``, ``bq``, ``bkv``) are accepted and ignored: each wrapper gives
the same values with JAX's keywords as without them.  ``rwkv6_scan``, the
raw kernel entry, has JAX's signature and refuses CPU tensors.
"""
import inspect

import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as j_flash
from repro.kernels.flash_attention import flash_attention_diff as j_flash_diff
from repro.kernels.flash_attention import mha as j_mha
from repro.kernels.rwkv6 import rwkv6 as j_rwkv6
from repro.kernels.rwkv6 import rwkv6_diff as j_rwkv6_diff
from repro.kernels.rwkv6 import rwkv6_scan as j_rwkv6_scan
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import rwkv6 as rk

torch.set_num_threads(1)


def _rwkv_inputs(seed=0, b=1, h=2, t=20, d=8):
    rng = np.random.default_rng(seed)
    r, k, v = (torch.from_numpy(rng.standard_normal((b, h, t, d)).astype(np.float32))
               for _ in range(3))
    w = torch.from_numpy(rng.uniform(0.5, 0.99, (b, h, t, d)).astype(np.float32))
    u = torch.from_numpy(rng.standard_normal((h, d)).astype(np.float32))
    s0 = torch.from_numpy(rng.standard_normal((b, h, d, d)).astype(np.float32))
    return r, k, v, w, u, s0


def _qkv(seed=0, b=1, hq=4, hkv=2, s=24, dh=16):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((b, hh, s, dh)).astype(np.float32))
            for hh in (hq, hkv, hkv)]


def _kwonly(fn):
    return {n for n, p in inspect.signature(fn).parameters.items() if p.kind == p.KEYWORD_ONLY}


@pytest.mark.parametrize("port,ref", [(rk.rwkv6, j_rwkv6), (rk.rwkv6_diff, j_rwkv6_diff),
                                      (rk.rwkv6_scan, j_rwkv6_scan),
                                      (fa.flash_attention, j_flash),
                                      (fa.flash_attention_diff, j_flash_diff),
                                      (fa.mha, j_mha)])
def test_wrappers_accept_every_jax_keyword(port, ref):
    assert _kwonly(getattr(ref, "__wrapped__", ref)) <= _kwonly(port)


@pytest.mark.parametrize("fn", ["rwkv6", "rwkv6_diff"])
def test_rwkv6_ignores_the_tpu_knobs(fn):
    args = _rwkv_inputs()
    plain = getattr(rk, fn)(*args)
    for kw in (dict(chunk=4), dict(chunk=128, interpret=False), dict(interpret=True)):
        got = getattr(rk, fn)(*args, **kw)
        for a, b in zip(got, plain):
            assert torch.equal(a, b), kw


def test_rwkv6_impl_has_jax_meaning():
    args = _rwkv_inputs(1)
    kernel = rk.rwkv6(*args)
    assert all(torch.equal(a, b) for a, b in zip(rk.rwkv6(*args, impl="pallas"), kernel))
    xla = rk.rwkv6(*args, impl="xla", chunk=16, interpret=False)
    want = rk.rwkv6_ref(*args)
    assert all(torch.equal(a, b) for a, b in zip(xla, want))
    o, s = rk.rwkv6(*args[:5], impl="xla")                  # no initial state
    assert o.shape == args[0].shape and s.shape == args[5].shape
    with pytest.raises(ValueError, match="unknown rwkv6 impl"):
        rk.rwkv6(*args, impl="triton")


def test_rwkv6_scan_is_the_raw_kernel_entry():
    args = _rwkv_inputs(2)
    with pytest.raises(ValueError, match="CUDA tensors"):
        rk.rwkv6_scan(*args)
    with pytest.raises(ValueError, match="CUDA tensors"):
        rk.rwkv6_scan(*args[:5], chunk=64, interpret=True)
    assert "rwkv6_scan" in rk.__all__


@pytest.mark.parametrize("fn", ["flash_attention", "flash_attention_diff", "mha"])
@pytest.mark.parametrize("causal,window", [(True, None), (False, None), (True, 8)])
def test_flash_wrappers_ignore_the_tpu_knobs(fn, causal, window):
    q, k, v = _qkv()
    plain = getattr(fa, fn)(q, k, v, causal=causal, window=window)
    knobs = [dict(interpret=True), dict(interpret=False)]
    if fn != "mha":
        knobs += [dict(bq=8, bkv=16), dict(bq=128, bkv=128, interpret=False)]
    else:
        knobs += [dict(impl="pallas", interpret=False)]
    for kw in knobs:
        assert torch.equal(getattr(fa, fn)(q, k, v, causal=causal, window=window, **kw),
                           plain), kw
