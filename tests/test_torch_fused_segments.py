"""The fused kernel's schedule in plain PyTorch: per-candidate tile segments.

On the card the fused Θ kernel orders each candidate's live keys by their
256-bin tile first, so that each (candidate, tile) reads only its own
segment (``csrc/fused_theta.cu``).  Its plain version is
``ref.candidate_segments`` / ``ref.fused_theta_segments_ref``:

* each live key of candidate c in tile t lies in segment (c, t) exactly
  once; keys at or past ``n_bins``, -1 sentinels, w = 0 and d outside
  ``[0, n_dec)`` are in no segment — against brute force;
* Θ composed through the segments is the same bits as ``fused_theta_ref``
  for all four measures (every tile's contingency is the same integer-valued
  f32 counts), with every key of a candidate in one tile (K = 1), in a few
  tiles (K = 4) and spread over all of them;
* and agrees with the JAX package's fused kernel in interpret mode, Θ_PR
  bit-equal, the others within rtol = 1e-5, atol = 1e-6·max|want|.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.contingency import ops as jops
from repro_torch.kernels.contingency import ref

torch.set_num_threads(1)

DELTAS = ["PR", "SCE", "LCE", "CCE"]
N_DEC = 5


def _operands(seed, *, nc, g, n_bins, spread, junk=True):
    """Keys drawn from the first ``spread`` bins (all of them: "uniform");
    with ``junk`` also keys past n_bins, -1 sentinels, w = 0 and d = n_dec."""
    rng = np.random.default_rng(seed)
    hi = n_bins if spread == "uniform" else min(n_bins, spread)
    packed = rng.integers(0, hi, (nc, g)).astype(np.int32)
    d = rng.integers(0, N_DEC, g).astype(np.int32)
    w = rng.integers(1, 9, g).astype(np.float32)
    if junk:
        slots = rng.random((nc, g))
        packed[slots < 0.05] = -1                                   # padding sentinels
        packed[(slots >= 0.05) & (slots < 0.1)] = n_bins + rng.integers(0, 300)
        cols = rng.random(g)
        w[cols < 0.05] = 0.0
        d[(cols >= 0.05) & (cols < 0.1)] = N_DEC                   # a decision past the table
        d[(cols >= 0.1) & (cols < 0.12)] = -1
    return [torch.from_numpy(a) for a in (packed, d, w)]


@pytest.mark.parametrize("spread", [1, 4, 300, "uniform"])
@pytest.mark.parametrize("n_bins", [256, 1000, 2600])
def test_each_live_key_lies_in_its_segment_once(spread, n_bins):
    nc, g = 3, 700
    packed, d, w = _operands(n_bins + 7, nc=nc, g=g, n_bins=n_bins, spread=spread)
    cand, gran, start = ref.candidate_segments(packed, d, w, n_bins=n_bins, n_dec=N_DEC)
    n_tiles = -(-n_bins // 256)
    assert start.numel() == nc * n_tiles + 1 and start[0] == 0
    live = {(c, x) for c in range(nc) for x in range(g)
            if 0 <= packed[c, x] < n_bins and 0 <= d[x] < N_DEC and w[x] != 0}
    assert start[-1] == len(live)
    seen = []
    for s in range(nc * n_tiles):
        c, t = divmod(s, n_tiles)
        for i in range(int(start[s]), int(start[s + 1])):
            assert int(cand[i]) == c
            assert 256 * t <= int(packed[c, gran[i]]) < 256 * (t + 1)
            seen.append((c, int(gran[i])))
    assert len(seen) == len(set(seen)) and set(seen) == live


def test_dropped_keys_are_in_no_segment():
    """One live key, and one of each kind that counts nothing."""
    packed = torch.tensor([[300, -1, 600, 5, 7]], dtype=torch.int32)
    d = torch.tensor([1, 1, 1, 1, N_DEC], dtype=torch.int32)
    w = torch.tensor([2.0, 1.0, 1.0, 0.0, 1.0])
    cand, gran, start = ref.candidate_segments(packed, d, w, n_bins=600, n_dec=N_DEC)
    assert gran.tolist() == [0] and cand.tolist() == [0]
    assert start.tolist() == [0, 0, 1, 1]                  # tile 1 of 3 holds key 300


@pytest.mark.parametrize("delta", DELTAS)
@pytest.mark.parametrize("spread", [1, 4, "uniform"])
@pytest.mark.parametrize("nc,n_bins", [(1, 300), (4, 2600), (3, 5000)])
def test_segments_compose_to_the_plain_theta_bits(delta, spread, nc, n_bins):
    packed, d, w = _operands(nc * 31 + n_bins, nc=nc, g=900, n_bins=n_bins, spread=spread)
    kw = dict(delta=delta, n_bins=n_bins, n_dec=N_DEC)
    got = ref.fused_theta_segments_ref(packed, d, w, 1000.0, **kw)
    want = ref.fused_theta_ref(packed, d, w, 1000.0, **kw)
    assert torch.equal(got, want)


@pytest.mark.parametrize("delta", DELTAS)
@pytest.mark.parametrize("spread", [1, "uniform"])
def test_segments_match_jax_fused(delta, spread):
    packed, d, w = _operands(11, nc=4, g=1200, n_bins=1000, spread=spread, junk=False)
    packed[:, -9:] = -1                                     # padding sentinels, as JAX's tests
    w[:20] = 0.0
    got = ref.fused_theta_segments_ref(packed, d, w, 1500.0, delta=delta, n_bins=1000,
                                       n_dec=N_DEC).numpy()
    want = np.asarray(jops.fused_theta(jnp.asarray(packed.numpy()), jnp.asarray(d.numpy()),
                                       jnp.asarray(w.numpy()), 1500.0, delta=delta,
                                       n_bins=1000, n_dec=N_DEC))
    if delta == "PR":
        np.testing.assert_array_equal(got, want)
    else:
        scale = float(np.abs(want).max())
        assert scale > 0
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * scale)
