"""The port's contingency kernel wrappers against the JAX package's kernels.

On the CPU each wrapper runs its kernel's plain version (repro_torch
kernels/contingency/ref.py); the JAX side runs the Pallas kernels in their
default interpret mode, as the JAX tests do.  Shapes span several 256-bin
tiles, with padding granules (zero weight, -1 keys) and a ragged last tile.

* contingency: bit-equal (integer-valued f32 counts).
* fused / sweep Θ: Θ_PR bit-equal; SCE/LCE/CCE within rtol=1e-5 and
  atol=1e-6·max|want| (the within-tile sum order differs between the
  frameworks; relative, so a tiny scaled CCE is still checked).
* inside the port: the sweep backends are bitwise invariant across ladder
  rungs, and every Θ backend agrees with materialize-then-evaluate.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import plan as jplan
from repro.kernels.contingency import ops as jops
from repro_torch.core import plan as tplan
from repro_torch.kernels import build
from repro_torch.kernels.contingency import ops, ref

# The tensors here are tiny: PyTorch's intra-op thread pool only adds
# overhead, and across pytest-xdist workers it oversubscribes the cores.
torch.set_num_threads(1)

DELTAS = ["PR", "SCE", "LCE", "CCE"]


def _assert_measure(delta, got, want):
    if delta == "PR":
        np.testing.assert_array_equal(got, want)
    else:
        scale = float(np.abs(want).max())
        assert scale > 0
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * scale)


def _slab(seed, nc, g, v, k, m, pad):
    """Sweep operands with `pad` trailing padding granules (r = -1, w = 0)."""
    rng = np.random.default_rng(seed)
    x_t = rng.integers(0, v, size=(nc, g)).astype(np.int32)
    r = rng.integers(0, k, size=g).astype(np.int32)
    d = rng.integers(0, m, size=g).astype(np.int32)
    w = rng.integers(1, 6, size=g).astype(np.float32)
    if pad:
        r[-pad:] = -1
        w[-pad:] = 0.0
    return x_t, r, d, w


CASES = [  # nc, G, V, K, m, n_bins (multi-tile, ragged last tile)
    (3, 300, 4, 100, 3, 400),
    (5, 517, 6, 120, 5, 768),
    (2, 260, 3, 300, 23, 900),
]


@pytest.mark.parametrize("case", CASES)
def test_contingency_bit_equal_jax(case):
    nc, g, v, k, m, n_bins = case
    x_t, r, d, w = _slab(nc * g, nc, g, v, k, m, pad=g // 10)
    packed = r[None, :] * v + x_t
    packed[:, -(g // 10):] = -1                     # the -1 padding sentinel
    got = ops.contingency(torch.from_numpy(packed), torch.from_numpy(d),
                          torch.from_numpy(w), n_bins=n_bins, n_dec=m).numpy()
    want = np.asarray(jops.contingency(jnp.asarray(packed), jnp.asarray(d),
                                       jnp.asarray(w), n_bins=n_bins, n_dec=m))
    np.testing.assert_array_equal(got, want)
    valid = w > 0
    seg = np.asarray(jplan.candidate_contingency(
        jnp.asarray(packed), jnp.asarray(d), jnp.asarray(w.astype(np.int32)),
        jnp.asarray(valid), n_bins=n_bins, m=m, backend="segment"))
    np.testing.assert_array_equal(got, seg)


@pytest.mark.parametrize("delta", DELTAS)
@pytest.mark.parametrize("case", CASES)
def test_fused_theta_matches_jax(delta, case):
    nc, g, v, k, m, n_bins = case
    x_t, r, d, w = _slab(nc + g, nc, g, v, k, m, pad=7)
    packed = r[None, :] * v + x_t
    packed[:, -7:] = -1
    n = float(w.sum())
    got = ops.fused_theta(torch.from_numpy(packed), torch.from_numpy(d),
                          torch.from_numpy(w), n, delta=delta, n_bins=n_bins,
                          n_dec=m).numpy()
    want = np.asarray(jops.fused_theta(jnp.asarray(packed), jnp.asarray(d),
                                       jnp.asarray(w), n, delta=delta,
                                       n_bins=n_bins, n_dec=m))
    _assert_measure(delta, got, want)


@pytest.mark.parametrize("delta", DELTAS)
@pytest.mark.parametrize("case", CASES)
def test_sweep_theta_matches_jax(delta, case):
    nc, g, v, k, m, n_bins = case
    x_t, r, d, w = _slab(2 * g + nc, nc, g, v, k, m, pad=11)
    n = float(w.sum())
    got = ops.sweep_theta(torch.from_numpy(x_t), torch.from_numpy(r),
                          torch.from_numpy(d), torch.from_numpy(w), n,
                          delta=delta, v_max=v, n_bins=n_bins, n_dec=m).numpy()
    want = np.asarray(jops.sweep_theta(jnp.asarray(x_t), jnp.asarray(r),
                                       jnp.asarray(d), jnp.asarray(w), n,
                                       delta=delta, v_max=v, n_bins=n_bins,
                                       n_dec=m))
    _assert_measure(delta, got, want)


@pytest.mark.parametrize("backend", ["sweep", "sweep_xla"])
def test_sweep_bitwise_invariant_across_rungs(backend):
    """The ladder's parity lemma inside the port: Θ is bit-identical at every
    rung ≥ K·V — dropped trailing tiles are exact f32 zeros in tile order."""
    rng = np.random.default_rng(3)
    G, nc, vmax, m, K = 300, 7, 4, 3, 37
    x_t = torch.from_numpy(rng.integers(0, vmax, (nc, G)).astype(np.int32))
    r = torch.from_numpy(rng.integers(0, K, (G,)).astype(np.int32))
    d = torch.from_numpy(rng.integers(0, m, (G,)).astype(np.int32))
    w = torch.from_numpy(rng.integers(1, 5, (G,)).astype(np.int32))
    valid = torch.from_numpy(rng.random(G) < 0.9)
    n = float(torch.where(valid, w, 0).sum())
    for delta in DELTAS:
        outs = [tplan.candidate_theta(delta, None, d, w, valid, n, n_bins=nb, m=m,
                                      backend=backend, x_t=x_t, r_ids=r, v_max=vmax).numpy()
                for nb in (256, 512, 1024, 1500)]
        for o in outs[1:]:
            np.testing.assert_array_equal(o, outs[0])


@pytest.mark.parametrize("delta", DELTAS)
def test_candidate_theta_backends_agree(delta):
    """Every Θ backend == materialize-then-evaluate; PR bit-equal across all."""
    rng = np.random.default_rng(13)
    nc, G, v, K, m = 4, 400, 5, 60, 4
    n_bins = K * v
    x_t = torch.from_numpy(rng.integers(0, v, (nc, G)).astype(np.int32))
    r = torch.from_numpy(rng.integers(0, K, (G,)).astype(np.int32))
    d = torch.from_numpy(rng.integers(0, m, (G,)).astype(np.int32))
    w = torch.from_numpy(rng.integers(1, 9, (G,)).astype(np.int32))
    valid = torch.from_numpy(rng.random(G) < 0.85)
    n = torch.where(valid, w, 0).sum().to(torch.int32)
    packed = (r[None, :] * v + x_t).contiguous()
    base = tplan.candidate_theta(delta, packed, d, w, valid, n, n_bins=n_bins, m=m,
                                 backend="segment").numpy()
    for backend in ("onehot", "pallas", "fused", "fused_xla"):
        got = tplan.candidate_theta(delta, packed, d, w, valid, n, n_bins=n_bins,
                                    m=m, backend=backend).numpy()
        _assert_measure(delta, got, base)
    for backend in ("sweep", "sweep_xla"):
        got = tplan.candidate_theta(delta, None, d, w, valid, n, n_bins=n_bins, m=m,
                                    backend=backend, x_t=x_t, r_ids=r, v_max=v).numpy()
        _assert_measure(delta, got, base)
    want = np.asarray(jplan.candidate_theta(
        delta, jnp.asarray(packed.numpy()), jnp.asarray(d.numpy()),
        jnp.asarray(w.numpy()), jnp.asarray(valid.numpy()), int(n),
        n_bins=n_bins, m=m, backend="segment"))
    _assert_measure(delta, base, want)


def test_plain_versions_define_the_wrappers_and_count_nothing_on_cpu():
    """On the CPU a wrapper is its plain version, and launches no kernel."""
    ops.reset_launch_counts()
    x_t, r, d, w = (torch.from_numpy(a) for a in _slab(1, 3, 200, 4, 50, 3, pad=5))
    packed = (r[None, :] * 4 + x_t).contiguous()
    torch.testing.assert_close(
        ops.sweep_theta(x_t, r, d, w, 100.0, delta="SCE", v_max=4, n_bins=300, n_dec=3),
        ref.sweep_theta_ref(x_t, r, d, w, 100.0, delta="SCE", v_max=4, n_bins=300, n_dec=3),
        rtol=0, atol=0)
    torch.testing.assert_close(
        ops.fused_theta(packed, d, w, 100.0, delta="LCE", n_bins=300, n_dec=3),
        ref.fused_theta_ref(packed, d, w, 100.0, delta="LCE", n_bins=300, n_dec=3),
        rtol=0, atol=0)
    assert ops.launch_counts() == {"contingency": 0, "fused_theta": 0, "sweep_theta": 0}
    family = {n for n, k in build.KERNELS.items() if k.family == "contingency"}
    assert family == set(ops.LAUNCHES)
    for k in build.KERNELS.values():
        assert (k.csrc / k.source).is_file()
        for h in k.headers:
            assert (k.csrc / h).is_file()


def test_wrappers_reject_other_devices_and_bad_args():
    meta = torch.empty((2, 8), dtype=torch.int32, device="meta")
    cpu_d = torch.zeros(8, dtype=torch.int32)
    cpu_w = torch.ones(8)
    with pytest.raises(ValueError, match="CPU or all on one CUDA"):
        ops.contingency(meta, cpu_d, cpu_w, n_bins=4, n_dec=2)
    with pytest.raises(ValueError, match="CPU or all on one CUDA"):
        ops.fused_theta(meta, cpu_d, cpu_w, 8.0, delta="PR", n_bins=4, n_dec=2)
    with pytest.raises(ValueError, match="slab"):
        tplan.candidate_theta("PR", torch.zeros((2, 8), dtype=torch.int32), cpu_d,
                              torch.ones(8, dtype=torch.int32),
                              torch.ones(8, dtype=torch.bool), 8.0, n_bins=16, m=2,
                              backend="sweep")
    with pytest.raises(ValueError, match="unknown Θ backend"):
        tplan.candidate_theta("PR", torch.zeros((2, 8), dtype=torch.int32), cpu_d,
                              torch.ones(8, dtype=torch.int32),
                              torch.ones(8, dtype=torch.bool), 8.0, n_bins=16, m=2,
                              backend="nope")


def test_ladder_rungs_match_jax():
    for n_bins in (1, 100, 256, 300, 1024, 6144, 1_310_720):
        assert tplan.ladder_rungs(n_bins) == jplan.ladder_rungs(n_bins)
        rungs = tplan.ladder_rungs(n_bins)
        for k in (1, 3, 64, 1000):
            if k * 4 <= n_bins:
                assert tplan.rung_for(k, 4, rungs) == jplan.rung_for(k, 4, rungs)
    # the analytic selector keeps the full pow2 ladder in the port
    assert tplan.ladder_rungs(4096, selector="analytic", g=64, m=2) == (256, 512, 1024, 2048, 4096)
