"""The sweep kernel's schedule in plain PyTorch: tile segments and their Θ.

On the card the sweep Θ kernel orders the live granules by the tile bucket
of their class, so that each 256-bin tile reads only its own segment
(``csrc/sweep_theta.cu``).  Its plain version is
``ref.tile_segments`` / ``ref.sweep_theta_segments_ref``:

* each tile's segment holds exactly the live granules whose class has a key
  in the tile (V ≤ 256; a class straddling two tiles is in both), padding
  (r = -1, w = 0, d out of range) excluded — against brute force;
* Θ composed through the segments is the same bits as ``sweep_theta_ref``
  for all four measures (every tile's contingency is the same integer-valued
  f32 counts), including K = 1, where every granule lies in one tile, and
  n_bins not a multiple of 256;
* and agrees with the JAX package's sweep kernel in interpret mode on a
  skewed (K = 1) input, Θ_PR bit-equal, the others within rtol = 1e-5,
  atol = 1e-6·max|want|.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.contingency import ops as jops
from repro_torch.kernels.contingency import ref

torch.set_num_threads(1)

DELTAS = ["PR", "SCE", "LCE", "CCE"]
V_VALUES = [1, 3, 10, 256]


def _operands(seed, *, nc, g, v, k, n_dec=5, pad=0.15):
    rng = np.random.default_rng(seed)
    x_t = rng.integers(0, v, (nc, g)).astype(np.int32)
    r = rng.integers(0, k, g).astype(np.int32)
    d = rng.integers(0, n_dec, g).astype(np.int32)
    w = rng.integers(1, 9, g).astype(np.float32)
    slots = rng.random(g)
    r[slots < pad / 3] = -1                      # padding granules
    w[(slots >= pad / 3) & (slots < 2 * pad / 3)] = 0.0
    d[(slots >= 2 * pad / 3) & (slots < pad)] = n_dec   # a decision past the table
    return [torch.from_numpy(a) for a in (x_t, r, d, w)]


def _n_bins(v, k):
    return k * v + 37        # a ragged last tile: never a multiple of 256 here


@pytest.mark.parametrize("v", V_VALUES)
@pytest.mark.parametrize("k_of", ["one", "few", "all"])
def test_tile_segments_hold_exactly_the_classes_of_the_tile(v, k_of):
    k = {"one": 1, "few": 7, "all": 600 // v + 3}[k_of]
    n_bins, n_dec = _n_bins(v, k), 5
    _, r, d, w = _operands(v * 100 + k, nc=1, g=900, v=v, k=k)
    perm, start, seg_begin, seg_end = ref.tile_segments(r, d, w, v_max=v, n_bins=n_bins,
                                                        n_dec=n_dec)
    live = [g for g in range(r.numel())
            if 0 <= r[g] < -(-n_bins // v) and 0 <= d[g] < n_dec and w[g] != 0]
    assert sorted(perm.tolist()) == live                   # padding excluded, none lost
    assert start[0] == 0 and start[-1] == len(live)
    for t in range(seg_begin.numel()):
        lo, hi = 256 * t, min(256 * t + 256, n_bins)
        want = {g for g in live if int(r[g]) * v < hi and int(r[g]) * v + v > lo}
        got = perm[seg_begin[t]:seg_end[t]].tolist()
        assert len(got) == len(set(got)) and set(got) == want, t


def test_class_straddling_two_tiles_is_in_both_segments():
    """V = 10: class 25 owns keys 250..259, across the tiles 0 and 1."""
    r = torch.tensor([25, 3, 26, -1], dtype=torch.int32)
    d = torch.zeros(4, dtype=torch.int32)
    w = torch.ones(4)
    perm, _, seg_begin, seg_end = ref.tile_segments(r, d, w, v_max=10, n_bins=600, n_dec=1)
    tiles = [set(perm[b:e].tolist()) for b, e in zip(seg_begin.tolist(), seg_end.tolist())]
    assert tiles == [{0, 1}, {0, 2}, set()]


@pytest.mark.parametrize("delta", DELTAS)
@pytest.mark.parametrize("v", V_VALUES)
@pytest.mark.parametrize("k_of,nc", [("one", 3), ("few", 1), ("all", 4)])
def test_segments_compose_to_the_plain_theta_bits(delta, v, k_of, nc):
    k = {"one": 1, "few": 7, "all": 700 // v + 5}[k_of]
    n_bins = _n_bins(v, k)
    x_t, r, d, w = _operands(v + k + nc, nc=nc, g=800, v=v, k=k)
    kw = dict(delta=delta, v_max=v, n_bins=n_bins, n_dec=5)
    got = ref.sweep_theta_segments_ref(x_t, r, d, w, 900.0, **kw)
    want = ref.sweep_theta_ref(x_t, r, d, w, 900.0, **kw)
    assert torch.equal(got, want)


@pytest.mark.parametrize("delta", DELTAS)
def test_segments_match_jax_sweep_on_one_class(delta):
    x_t, r, d, w = _operands(5, nc=6, g=1200, v=10, k=1, n_dec=23)
    d = torch.clamp(d, max=22)
    got = ref.sweep_theta_segments_ref(x_t, r, d, w, 1500.0, delta=delta, v_max=10,
                                       n_bins=1000, n_dec=23).numpy()
    want = np.asarray(jops.sweep_theta(jnp.asarray(x_t.numpy()), jnp.asarray(r.numpy()),
                                       jnp.asarray(d.numpy()), jnp.asarray(w.numpy()), 1500.0,
                                       delta=delta, v_max=10, n_bins=1000, n_dec=23))
    if delta == "PR":
        np.testing.assert_array_equal(got, want)
    else:
        scale = float(np.abs(want).max())
        assert scale > 0
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * scale)
