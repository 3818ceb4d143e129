"""The port's CUDA kernels on the card, each against its plain version.

Marked ``cuda``: every test takes the ``cuda_device`` fixture, which skips
with a reason where PyTorch sees no card (the decision is made inside the
fixture, never at import).  On a machine with a card and ``nvcc``:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: contingency and Θ_PR bit-equal (integer-valued f32 counts);
SCE/LCE/CCE rtol=1e-5, atol=1e-6·max|plain| (the within-tile sum order
differs; relative, because the scaled CCE reads ~1e-8 at these shapes).

The sweep kernel orders granules into per-tile segments first; its cases
cover every granule in one class (K = 1, one segment split over several
CTAs), a few classes, and one class per few granules, at V ∈ {1, 3, 10,
256}, with padding (r = -1, w = 0), n_bins not a multiple of 256 and
nc = 1.  Its results are the same bits on every run, at every rung, and
(Θ_PR) as the fused kernel's.

The fused kernel orders each candidate's keys by tile first; its cases
cover every key of a candidate in one tile (K = 1, one segment split over
several CTAs), in a few (K = 4) or many (K = 1,024) classes, and uniform
keys, plus arbitrary keys (not r·V + x) with sentinels and keys past
n_bins, and G past 2^23 (where an ordered entry holds g alone).  Its
results are the same bits on every run and (Θ_PR) as the sweep's.

The core step at kdd99's shapes (100,000 of 131,072 slots live, 41
columns, v_max 10, so a rank of two partitions takes two sort keys):
the prefix/suffix partitions give the per-attribute sort chains' Θ bit
for bit on the card, Θ_PR and Θ_SCE, with one host read in
``reduce.core``.

The device-resident engine (a CUDA graph of the greedy body, replayed)
equals the host loop on the card bit for bit; one config captures once
across calls, a second table of the same shape gets its own answer (the
operands are copied into the graph's buffers, never baked in), a seed with
``theta_full = +inf`` then a resume equals the cold run, and each ensemble
member equals its solo run.

``segment`` on the card evaluates candidates through the fused kernel: one
``fused_theta`` launch a chunk, the CPU path's Θ within 1e-6·max(1, |Θ|)
(and the tolerance above), Θ_PR bit for bit; a stacked body of the four
measures at kdd99's shape grows the card's reserved memory by less than one
dense candidate contingency, and its dispatch span counts the launches the
replayed bodies held.

The online service on the card: an engine capture with a merge running on
another thread (the device guard keeps the merge out of the capture; both
answers equal their solo runs), a timed-out dispatch whose retry adopts the
running call (the untimed answer, one engine run), a handle's checkpoint
round trip, and the server streaming the shuttle table (58,000 rows) with
the four Θ backends bit-equal on Θ_PR and a stacked window of four clients.

The mesh driver on the card: the fused kernel's raw partials over four
class-grouped parts sum, scaled once, to the unsplit Θ (the ``fused``
schedule's identity, at kdd99 shapes), and a world of one NCCL rank (mesh
(1, 1)) gives the solo reduction on every schedule and engine, the device
engine capturing its body with the collectives in it; the adapter's NCCL
reduce_scatter runs eagerly and captured, and ``engine="auto"`` takes the
host loop where the device engine's working set does not fit the card.

Tile selection on the card: every feasible tiling of each kernel
(``model.feasible_tiles``) gives the plain version's bits (the contingency
and Θ_PR; Θ_SCE the same bits across tilings, within the tolerance above of
the plain version), with long split segments and short ones, at n_dec 2
and 23; and the sweep kernel inside the device engine's captured body is
captured anew, not replayed, once a persisted tuning changes its tiles.

The paper's widest table and the dry-run cell on the card: the sdss stand-in
at its full 5,201 attributes (rows cut to 3,000) reduces on the three kernel
backends to ``segment``'s reduct on the card and on the CPU, Θ_PR bit for
bit; the dry-run cell's shard steps on a world of one NCCL rank equal the
solo evaluation on every form.
"""
import numpy as np
import pytest
import torch
from _core_chain import core_by_subset_chains

from repro_torch import obs
from repro_torch.core import engine, granularity_from_numpy, plar_reduce, plar_reduce_ensemble
from repro_torch.core.plan import candidate_theta
from repro_torch.core.reduction import _core_inner_thetas
from repro_torch.kernels.contingency import ops, ref

pytestmark = pytest.mark.cuda

DELTAS = ["PR", "SCE", "LCE", "CCE"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _operands(dev, seed, nc=9, g=5000, v=10, k=300, m=23, pad=400):
    gen = torch.Generator().manual_seed(seed)
    x_t = torch.randint(0, v, (nc, g), generator=gen, dtype=torch.int32)
    r = torch.randint(0, k, (g,), generator=gen, dtype=torch.int32)
    d = torch.randint(0, m, (g,), generator=gen, dtype=torch.int32)
    w = torch.randint(1, 50, (g,), generator=gen).to(torch.float32)
    r[-pad:] = -1                                      # padding granules
    w[-pad:] = 0.0
    w[: pad // 2] = 0.0                                # zero-weight slots with a class
    return [t.to(dev) for t in (x_t, r, d, w)]


def _close(delta, got, want):
    if delta == "PR":
        assert torch.equal(got, want)
    else:
        scale = float(want.abs().max())
        assert scale > 0
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6 * scale)


@pytest.mark.parametrize("n_bins", [160, 3000, 10_240])
def test_contingency_kernel_bit_equal(cuda_device, n_bins):
    x_t, r, d, w = _operands(cuda_device, n_bins)
    packed = (r[None, :] * 10 + x_t).contiguous()
    before = ops.launch_counts()["contingency"]
    got = ops.contingency(packed, d, w, n_bins=n_bins, n_dec=23)
    torch.cuda.synchronize()
    assert ops.launch_counts()["contingency"] == before + 1
    assert torch.equal(got, ref.contingency_ref(packed, d, w, n_bins=n_bins, n_dec=23))


@pytest.mark.parametrize("delta", DELTAS)
@pytest.mark.parametrize("n_bins", [160, 3000, 10_240])
def test_theta_kernels_match_plain(cuda_device, delta, n_bins):
    x_t, r, d, w = _operands(cuda_device, n_bins + 1)
    packed = (r[None, :] * 10 + x_t).contiguous()
    n = float(w.sum())
    got_s = ops.sweep_theta(x_t, r, d, w, n, delta=delta, v_max=10, n_bins=n_bins, n_dec=23)
    got_f = ops.fused_theta(packed, d, w, n, delta=delta, n_bins=n_bins, n_dec=23)
    want = ref.sweep_theta_ref(x_t, r, d, w, n, delta=delta, v_max=10, n_bins=n_bins, n_dec=23)
    torch.cuda.synchronize()
    _close(delta, got_s, want)
    _close(delta, got_f, want)


@pytest.mark.parametrize("k", [100, 1])
def test_sweep_kernel_rung_invariant_and_deterministic(cuda_device, k):
    """Bitwise equal at every rung ≥ K·V, and from one run to the next; K = 1
    is the skewed first greedy iteration (every granule in tile 0, its
    segment split over several CTAs at g = 20,000)."""
    x_t, r, d, w = _operands(cuda_device, 7, k=k, g=20_000 if k == 1 else 5000)
    valid = torch.ones_like(w, dtype=torch.bool)
    for delta in DELTAS:
        outs = [candidate_theta(delta, None, d, w, valid, 1000.0, n_bins=nb, m=23,
                                backend="sweep", x_t=x_t, r_ids=r, v_max=10)
                for nb in (1024, 2048, 4096, 4096, 1_310_720)]
        for o in outs[1:]:
            assert torch.equal(o, outs[0])


@pytest.mark.parametrize("delta", DELTAS)
@pytest.mark.parametrize("v", [1, 3, 10, 256])
@pytest.mark.parametrize("k_of,nc,g", [("one", 5, 30_000), ("few", 1, 3000),
                                       ("all", 9, 8000)])
def test_sweep_kernel_on_segments_matches_plain(cuda_device, delta, v, k_of, nc, g):
    """K = 1 (one segment longer than a CTA's 4,096-granule chunk), K = 7,
    and K = n_bins / V (a few granules a tile), n_bins = K·V + 37."""
    k = {"one": 1, "few": 7, "all": max(1, g // 3 // v)}[k_of]
    n_bins = k * v + 37
    x_t, r, d, w = _operands(cuda_device, v * 7 + nc, nc=nc, g=g, v=v, k=k)
    n = float(w.sum())
    kw = dict(delta=delta, v_max=v, n_bins=n_bins, n_dec=23)
    before = ops.launch_counts()["sweep_theta"]
    got = ops.sweep_theta(x_t, r, d, w, n, **kw)
    again = ops.sweep_theta(x_t, r, d, w, n, **kw)
    torch.cuda.synchronize()
    assert ops.launch_counts()["sweep_theta"] == before + 2
    _close(delta, got, ref.sweep_theta_ref(x_t, r, d, w, n, **kw))
    assert torch.equal(got, again)


@pytest.mark.parametrize("k", [1, 7, 300])
def test_sweep_equals_fused_on_theta_pr(cuda_device, k):
    x_t, r, d, w = _operands(cuda_device, 11 + k, k=k, g=12_000)
    packed = (r[None, :] * 10 + x_t).contiguous()
    n = float(w.sum())
    got_s = ops.sweep_theta(x_t, r, d, w, n, delta="PR", v_max=10, n_bins=3000, n_dec=23)
    got_f = ops.fused_theta(packed, d, w, n, delta="PR", n_bins=3000, n_dec=23)
    assert torch.equal(got_s, got_f)


def test_wrappers_raise_on_bad_operands(cuda_device):
    x_t, r, d, w = _operands(cuda_device, 3)
    with pytest.raises(TypeError, match="float32"):
        ops.sweep_theta(x_t, r, d, w.to(torch.float64), 1.0, delta="PR", v_max=10,
                        n_bins=3000, n_dec=23)
    with pytest.raises(ValueError, match="shared memory"):
        ops.fused_theta(x_t, d, w, 1.0, delta="PR", n_bins=3000, n_dec=100_000)
    with pytest.raises(ValueError, match="CPU or all on one CUDA"):
        ops.contingency(x_t, d.cpu(), w, n_bins=3000, n_dec=23)


@pytest.mark.parametrize("backend", ["sweep", "fused", "pallas"])
def test_plar_on_card_matches_cpu(cuda_device, backend):
    rng = np.random.default_rng(0)
    x = rng.integers(0, 4, (3000, 10)).astype(np.int32)
    x[:, 5] = x[:, 2]
    d = ((x[:, 0] + x[:, 3]) % 3).astype(np.int32)
    ops.reset_launch_counts()
    for delta in DELTAS:
        rc = plar_reduce(x, d, delta=delta, backend=backend, device=cuda_device)
        rp = plar_reduce(x, d, delta=delta, backend=backend, device="cpu")
        assert (rc.reduct, rc.core) == (rp.reduct, rp.core)
        if delta == "PR":
            assert rc.theta_history == rp.theta_history
        else:
            np.testing.assert_allclose(rc.theta_history, rp.theta_history, rtol=1e-6, atol=1e-7)
    name = {"sweep": "sweep_theta", "fused": "fused_theta", "pallas": "contingency"}[backend]
    assert ops.launch_counts()[name] > 0


def test_plar_on_card_rejects_codes_past_v_max(cuda_device):
    """A code planted at v_max (a caller's understated v_max) is refused
    before the sweep kernel runs: the kernel reads only the keys of a tile's
    own classes and would drop it, where the plain version counts it."""
    rng = np.random.default_rng(1)
    x = rng.integers(0, 4, (3000, 10)).astype(np.int32)
    x[1234, 7] = 4
    d = (x[:, 0] % 3).astype(np.int32)
    ops.reset_launch_counts()
    with pytest.raises(ValueError, match=r"codes in \[0, 4\]"):
        plar_reduce(x, d, v_max=4, backend="sweep", device=cuda_device)
    assert ops.launch_counts()["sweep_theta"] == 0
    r = plar_reduce(x, d, v_max=5, backend="sweep", device=cuda_device)
    assert r.reduct == plar_reduce(x, d, v_max=5, backend="sweep", device="cpu").reduct


def _kdd99_shaped_granularity(dev, seed=27):
    """100,000 live granules in kdd99's capacity of 131,072, 41 columns at
    v_max 10 and 23 decisions: codes mostly 0 and 0.4 of the columns copies,
    so that dropping a column merges some granules and Θ differs by column."""
    cap, live, a, v, m = 131_072, 100_000, 41, 10, 23
    rng = np.random.default_rng(seed)
    x = np.where(rng.random((cap, a)) < 0.7, 0, rng.integers(1, v, (cap, a))).astype(np.int32)
    for j in range(1, a):
        if rng.random() < 0.4:
            x[:, j] = x[:, rng.integers(0, j)]
    valid = np.arange(cap) < live
    w = np.where(valid, rng.integers(1, 50, cap), 0).astype(np.int32)
    d = rng.integers(0, m, cap).astype(np.int32)
    return granularity_from_numpy(x, d, w, valid, live, int(w.sum()), n_attrs=a, n_dec=m,
                                  v_max=v, device=dev)


@pytest.mark.parametrize("delta", ["PR", "SCE"])
def test_core_partitions_equal_sort_chains_at_kdd99_shape(cuda_device, delta):
    gran = _kdd99_shaped_granularity(cuda_device)
    assert gran.capacity ** 2 >= 1 << 32             # the final ranks take two keys
    got = _core_inner_thetas(gran, delta, exact=True)
    want = core_by_subset_chains(gran, delta)
    assert np.array_equal(got, want)
    assert len(np.unique(got)) > 1                   # not every column alike
    tracer = obs.get_tracer()
    was = tracer.enabled
    tracer.clear()
    tracer.enable()
    try:
        r = plar_reduce(source=gran, delta=delta, backend="sweep", device=cuda_device)
        (core,) = [s for s in tracer.records() if s.ph == "X" and s.name == "reduce.core"]
    finally:
        tracer.clear()
        tracer.enabled = was
    assert core.args["host_reads"] == 1
    assert core.args["core"] == len(r.core)


@pytest.mark.parametrize("delta", DELTAS)
@pytest.mark.parametrize("k", [1, 4, 1024, "uniform"])
def test_fused_kernel_on_segments_matches_plain(cuda_device, delta, k):
    """Keys r·V + x at n_bins = 40,960 (160 tiles), r in [0, K); at K = 1
    each candidate's 26,000 live keys are one segment cut into chunks."""
    n_bins, v = 40_960, 10
    kk = n_bins // v if k == "uniform" else k
    x_t, r, d, w = _operands(cuda_device, 21 + kk, nc=6, g=30_000, v=v, k=kk)
    packed = (r[None, :] * v + x_t).contiguous()        # padding r = -1: negative keys
    n = float(w.sum())
    kw = dict(delta=delta, n_bins=n_bins, n_dec=23)
    before = ops.launch_counts()["fused_theta"]
    got = ops.fused_theta(packed, d, w, n, **kw)
    again = ops.fused_theta(packed, d, w, n, **kw)
    torch.cuda.synchronize()
    assert ops.launch_counts()["fused_theta"] == before + 2
    _close(delta, got, ref.fused_theta_ref(packed, d, w, n, **kw))
    assert torch.equal(got, again)
    if delta == "PR":
        assert torch.equal(got, ops.sweep_theta(x_t, r, d, w, n, v_max=v, **kw))


@pytest.mark.parametrize("delta", DELTAS)
def test_fused_kernel_at_g_past_2_pow_23(cuda_device, delta):
    """From G = 2^23 on an ordered entry is g alone (g << 8 would
    overflow) and the tile kernels read the key again (a ``--no-grc``
    table of weka15360 has G = 15,360,000): nc = 2, G = 2^23 + 4,097, keys
    r·V + x with padding, against plain and (Θ_PR) the sweep."""
    v = 10
    x_t, r, d, w = _operands(cuda_device, 23, nc=2, g=(1 << 23) + 4097, v=v, k=300)
    packed = (r[None, :] * v + x_t).contiguous()
    n = float(w.sum())
    kw = dict(delta=delta, n_bins=3000, n_dec=23)
    got = ops.fused_theta(packed, d, w, n, **kw)
    _close(delta, got, ref.fused_theta_ref(packed, d, w, n, **kw))
    assert torch.equal(got, ops.fused_theta(packed, d, w, n, **kw))
    if delta == "PR":
        assert torch.equal(got, ops.sweep_theta(x_t, r, d, w, n, v_max=v, **kw))


@pytest.mark.parametrize("delta", DELTAS)
@pytest.mark.parametrize("n_bins", [300, 70_000])
def test_fused_kernel_takes_arbitrary_keys(cuda_device, delta, n_bins):
    """Keys drawn from [-5, n_bins + 500): sentinels and keys past the table
    count nothing, as in the plain version; nc = 1 and nc = 7."""
    gen = torch.Generator().manual_seed(n_bins)
    for nc in (1, 7):
        packed = torch.randint(-5, n_bins + 500, (nc, 9000), generator=gen, dtype=torch.int32)
        d = torch.randint(-1, 24, (9000,), generator=gen, dtype=torch.int32)
        w = torch.randint(0, 9, (9000,), generator=gen).to(torch.float32)
        packed, d, w = packed.to(cuda_device), d.to(cuda_device), w.to(cuda_device)
        kw = dict(delta=delta, n_bins=n_bins, n_dec=23)
        _close(delta, ops.fused_theta(packed, d, w, 5000.0, **kw),
               ref.fused_theta_ref(packed, d, w, 5000.0, **kw))


def _engine_table(seed, n=3000, a=10):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 4, (n, a)).astype(np.int32)
    x[:, 5] = x[:, 2]
    x[0] = 3                                  # pins v_max: same shapes for every seed
    d = ((x[:, 0] + x[:, 3] + rng.integers(0, 2, n)) % 3).astype(np.int32)
    return x, d


def _same(a, b):
    return (a.reduct, a.core, a.iterations, a.theta_full, a.theta_history) == (
        b.reduct, b.core, b.iterations, b.theta_full, b.theta_history)


@pytest.mark.parametrize("backend,ladder", [("segment", False), ("sweep_xla", False),
                                            ("sweep_xla", True)])
@pytest.mark.parametrize("shrink", [False, True])
def test_device_engine_equals_host_loop_on_card(cuda_device, backend, ladder, shrink):
    """With the ladder on, the host loop evaluates at K-adaptive rungs and
    the device engine at the top rung: the same bits (§5.3)."""
    x, d = _engine_table(0)
    for delta in DELTAS:
        kw = dict(delta=delta, backend=backend, ladder=ladder, shrink=shrink,
                  device=cuda_device)
        rd = plar_reduce(x, d, engine="device", **kw)
        rh = plar_reduce(x, d, engine="host", **kw)
        assert _same(rd, rh), (delta, rd, rh)


def test_device_engine_one_capture_and_fresh_operands(cuda_device):
    """Two tables of one shape through one runner: one capture, and each
    table gets its own answer (the one the host loop gives it)."""
    x1, d1 = _engine_table(1)
    x2, d2 = _engine_table(2)
    kw = dict(delta="SCE", grc_init=False, device=cuda_device)
    r1 = plar_reduce(x1, d1, engine="device", **kw)
    runner = engine.make_engine_run("SCE", "incremental", "segment", 10, 3000, 3, 4, 1e-6,
                                    1e-5, False, 10, 64, device=cuda_device)
    assert runner.loop.captures == 1
    r2 = plar_reduce(x2, d2, engine="device", **kw)
    assert runner.loop.captures == 1
    assert _same(r1, plar_reduce(x1, d1, engine="host", **kw))
    assert _same(r2, plar_reduce(x2, d2, engine="host", **kw))


def test_device_engine_seed_then_resume_equals_cold(cuda_device):
    x, d = _engine_table(3)
    cold = plar_reduce(x, d, delta="PR", engine="device", compute_core=False,
                       grc_init=False, device=cuda_device)
    runner = engine.make_engine_run("PR", "incremental", "segment", 10, 3000, 3, 4, 1e-6,
                                    1e-5, False, 10, 64, device=cuda_device)
    xs, ds = torch.as_tensor(x, device=cuda_device), torch.as_tensor(d, device=cuda_device)
    ws = torch.ones(3000, dtype=torch.int32, device=cuda_device)
    valid = torch.ones(3000, dtype=torch.bool, device=cuda_device)
    k = max(len(cold.reduct) - 1, 1)
    st = engine.init_state_from_reduct(runner, 3000, 10, valid, xs, ds, ws, 3000,
                                       cold.reduct[:k])
    assert int(st.n_selected) == k
    fin = engine.engine_resume(runner, st, xs, ds, ws, 3000, cold.theta_full)
    reduct, hist, _, _ = engine.unpack_result(fin, 0)
    assert (reduct, hist) == (cold.reduct, cold.theta_history)
    assert runner.loop.captures == 1


@pytest.mark.parametrize("backend", ["segment", "sweep_xla"])
def test_ensemble_members_equal_solo_on_card(cuda_device, backend):
    x, d = _engine_table(4)
    grid = [{"delta": dd} for dd in DELTAS] + [{"delta": "SCE", "shrink": True},
                                               {"delta": "PR", "max_features": 2}]
    ens = plar_reduce_ensemble(x, d, configs=grid, backend=backend, device=cuda_device)
    for c, r in zip(grid, ens):
        assert _same(r, plar_reduce(x, d, engine="device", backend=backend,
                                    device=cuda_device, **c)), c


@pytest.mark.parametrize("delta", DELTAS)
def test_segment_candidate_theta_on_card_launches_fused(cuda_device, delta):
    """``segment`` on CUDA operands is the fused kernel's route: one launch,
    no other kernel, the CPU path's Θ (the dense contingency and
    ``measures.evaluate``) within 1e-6·max(1, |Θ|), Θ_PR bit for bit; with
    padding keys (r = -1), zero weights and invalid granules."""
    v, k, m = 10, 3000, 23
    x_t, r, d, w = _operands(cuda_device, 41, nc=9, g=20_000, v=v, k=k, m=m)
    packed = (r[None, :] * v + x_t).contiguous()
    valid = r >= 0
    valid[1000:1300] = False                          # live keys and weights, not valid
    n = torch.where(valid, w, 0).sum().to(torch.int32)
    args = (packed, d, w, valid, n)
    kw = dict(n_bins=k * v, m=m, backend="segment")
    ops.reset_launch_counts()
    got = candidate_theta(delta, *args, **kw).cpu()
    assert ops.launch_counts() == {"contingency": 0, "fused_theta": 1, "sweep_theta": 0}
    want = candidate_theta(delta, *(t.cpu() for t in args), **kw)
    if delta == "PR":
        assert torch.equal(got, want)
    else:
        gap = (got.double() - want.double()).abs() / want.double().abs().clamp(min=1.0)
        assert float(gap.max()) <= 1e-6
        _close(delta, got, want)


def test_stacked_body_at_kdd99_shape_holds_no_dense_contingency(cuda_device):
    """The four measures' stacked body on ``segment`` at kdd99's shape (41
    candidates, cap·V 1,310,720 bins, 23 decisions): its warm-up and capture
    grow the card's reserved memory (the graph pool included) by less than
    one dense candidate contingency, 41·1,310,720·23·4 bytes; the launch
    shape is resolved before the capture; the ``engine.dispatch_ensemble``
    span counts the fused launches the replayed bodies held."""
    cap, a, v, m, c = 131_072, 41, 10, 23, 4
    gen = torch.Generator().manual_seed(31)
    x = torch.randint(0, v, (cap, a), generator=gen, dtype=torch.int32)
    d = torch.randint(0, m, (cap,), generator=gen, dtype=torch.int32)
    w = torch.randint(1, 60, (cap,), generator=gen, dtype=torch.int32)
    valid = torch.arange(cap) < 99_700                # kdd99's live granules
    w[~valid] = 0
    ens = engine.EnsembleOperands(
        tol=torch.full((c,), 1e-6), tie_tol=torch.full((c,), 1e-5),
        max_sel=torch.full((c,), 3, dtype=torch.int32), shrink=torch.zeros(c, dtype=torch.bool),
        theta_full=torch.full((c,), -10.0), n=torch.full((c,), int(w.sum()), dtype=torch.int32),
        w=w.expand(c, cap).contiguous(), core_attrs=torch.zeros((c, a), dtype=torch.int32),
        core_count=torch.zeros((c,), dtype=torch.int32))
    engine.release_graphs()
    runner = engine.make_ensemble_run("incremental", "segment", DELTAS, a, cap, m, v, 64,
                                      device=cuda_device)
    assert runner.cfg.tiles and runner.loop.captures == 0
    x, d, valid = x.to(cuda_device), d.to(cuda_device), valid.to(cuda_device)
    torch.cuda.synchronize()
    before = torch.cuda.memory_reserved(cuda_device)
    obs.enable()
    try:
        fin, _loop_s = engine.run_ensemble(runner, cap, a, valid, x, d, ens)
        span = next(r for r in reversed(obs.get_tracer().records())
                    if r.name == "engine.dispatch_ensemble")
    finally:
        obs.disable()
    grown = torch.cuda.memory_reserved(cuda_device) - before
    assert grown < a * cap * v * m * 4, grown
    assert fin.n_selected.tolist() == [3] * c and runner.loop.captures == 1
    assert runner.loop.last_launches == c * span.args["bodies"]   # one chunk of 41 a member
    assert span.args["theta_launches"] == c * span.args["bodies"] > 0
    engine.release_graphs()


@pytest.mark.parametrize("ensemble", [False, True])
def test_segment_refuses_up_front_what_the_fused_kernel_cannot_take(cuda_device, ensemble):
    """A table of 230 decision classes passes a 256-bin tile's shared memory
    on the card: ``segment`` refuses it after granulation, before any
    launch or capture, naming the kernel; the CPU runs it on the dense
    path."""
    rng = np.random.default_rng(230)
    x = rng.integers(0, 3, (600, 4)).astype(np.int32)
    d = (np.arange(600) % 230).astype(np.int32)
    run = ((lambda dev: plar_reduce_ensemble(x, d, configs=DELTAS, device=dev)) if ensemble
           else (lambda dev: plar_reduce(x, d, delta="SCE", device=dev)))
    engine.release_graphs()
    ops.reset_launch_counts()
    with pytest.raises(ValueError, match="fused Θ kernel.*shared memory"):
        run(cuda_device)
    assert sum(ops.launch_counts().values()) == 0
    assert run("cpu")


# ---------------------------------------------------------------------------
# the online service on the card
# ---------------------------------------------------------------------------


def _service_table(name, rows, attrs):
    from repro_torch.data import scaled_paper_dataset

    stream = scaled_paper_dataset(name, max_rows=rows, max_attrs=attrs)
    return stream, stream.table()


def test_capture_overlapping_a_merge_gives_solo_answers(cuda_device):
    """Dataset B merges batch after batch on another thread while dataset
    A's reductions capture fresh CUDA graphs.  The device guard holds each
    merge out of each capture (one of them waits, and the guard counts
    it); A's answers equal their solo runs and B ends with the content of a
    one-shot build."""
    import threading

    from repro_torch.core.guard import device_guard
    from repro_torch.service import DatasetHandle

    stream, (x, d) = _service_table("kdd99", 240_000, 41)
    kw = dict(n_dec=stream.n_dec, v_max=stream.v_max, device=cuda_device)
    a = DatasetHandle.create(x[:120_000], d[:120_000], **kw)
    b = DatasetHandle.create(x[120_000:150_000], d[120_000:150_000], **kw)
    guard = device_guard(cuda_device)
    waits = guard.capture_waits + guard.shared_waits
    engine.release_graphs()                     # every config below captures afresh
    stop, merged = threading.Event(), [150_000]

    def merger():
        while not stop.is_set() and merged[-1] < 240_000:
            lo = merged[-1]
            b.update(x[lo:lo + 3_000], d[lo:lo + 3_000])
            merged.append(lo + 3_000)

    t = threading.Thread(target=merger)
    t.start()
    configs = [("PR", "segment"), ("SCE", "segment"), ("PR", "sweep_xla")]
    try:
        got = [a.reduce(delta, backend=backend) for delta, backend in configs]
    finally:
        stop.set()
        t.join(120)
    assert len(merged) > 2 and guard.capture_waits + guard.shared_waits > waits
    for (delta, backend), r in zip(configs, got):
        solo = plar_reduce(source=a.gran, delta=delta, backend=backend, device=cuda_device)
        assert _same(r, solo), (delta, backend)
    end = merged[-1]
    one_shot = DatasetHandle.create(x[120_000:end], d[120_000:end], **kw)
    assert b.fingerprint == one_shot.fingerprint
    assert _same(b.reduce("PR"), one_shot.reduce("PR"))


def test_timed_out_dispatch_retry_gives_untimed_answer_on_card(cuda_device):
    """A dispatch that captures takes longer than ``timeout_s``: the retries
    wait on the running call, so the engine runs once and the answer is the
    untimed server's, byte for byte."""
    import asyncio

    from repro_torch import obs
    from repro_torch.service import ReductServer, RetryPolicy

    stream, (x, d) = _service_table("shuttle", 4_000, 9)

    async def serve(retry):
        engine.release_graphs()                 # the dispatch captures: it is slow
        async with ReductServer(retry=retry, device=cuda_device) as srv:
            await srv.submit("s", x, d, n_dec=stream.n_dec, v_max=stream.v_max)
            runs = obs.get_registry().snapshot().get("plar_engine_runs_total", 0)
            r = await srv.query("s", "SCE")
            runs = obs.get_registry().snapshot()["plar_engine_runs_total"] - runs
            return r, dict(srv.stats), runs

    untimed, _, _ = asyncio.run(serve(None))
    timed, stats, runs = asyncio.run(serve(RetryPolicy(
        timeout_s=0.002, max_attempts=500, base_delay_s=0.001, max_delay_s=0.005)))
    assert stats["retries"] >= 1 and stats["quarantined"] == 0
    assert runs == 1                            # one engine run, adopted by its retries
    assert _same(timed, untimed)


def test_handle_checkpoint_round_trip_on_card(cuda_device, tmp_path):
    """A handle on the card checkpoints and restores onto the card (and onto
    the CPU) with the same arrays, fingerprint and cached results; the
    restored handle's warm repair equals the live one's."""
    from repro_torch.service import DatasetHandle, ServiceCheckpointer

    stream, (x, d) = _service_table("kdd99", 200_000, 41)
    h = DatasetHandle.create(x, d, n_dec=stream.n_dec, v_max=stream.v_max, device=cuda_device)
    for delta in ("PR", "SCE"):
        h.reduce(delta)
    ServiceCheckpointer(str(tmp_path), device=cuda_device).save({"ds": h})
    _step, handles = ServiceCheckpointer(str(tmp_path), device=cuda_device).restore()
    h2 = handles["ds"]
    assert h2.device.type == "cuda"
    for k in ("x", "d", "w", "valid", "num", "n_total"):
        assert torch.equal(getattr(h2.gran, k), getattr(h.gran, k)), k
    assert h2.fingerprint == h.fingerprint
    _step, on_cpu = ServiceCheckpointer(str(tmp_path), device="cpu").restore()
    assert on_cpu["ds"].fingerprint == h.fingerprint
    for delta in ("PR", "SCE"):
        assert _same(h2._results[(delta, (("exact", True),))],
                     h._results[(delta, (("exact", True),))])
        live, restored = h.reduce(delta), h2.reduce(delta)
        assert h2.last_was_warm and _same(restored, live)


def test_server_streams_shuttle_on_card(cuda_device):
    """The server on the card streams the shuttle table (58,000 x 9) in a
    half and 4 updates.  Each round: solo PR queries on ``segment`` (device
    engine), ``sweep``, ``fused`` and ``pallas`` (host loop, the three
    kernels) give equal reducts and bit-equal Θ_PR, and a window of four
    clients (PR, SCE, LCE, CCE) is one stacked dispatch.  Every answer
    equals the same stream served on the CPU (reducts equal, Θ_PR bit-equal,
    the other measures within rtol=1e-5) and reaches its stopping target;
    nothing was retried.  (At this size the warm repair keeps a prefix that
    a cold run orders differently, in the JAX package as here: repair
    guarantees a valid reduct, not the cold run's.)"""
    import asyncio

    from repro_torch.core.measures import f32_threshold
    from repro_torch.service import ReductServer

    stream, (x, d) = _service_table("shuttle", 58_000, 9)
    half, rest = len(x) // 2, len(x) - len(x) // 2

    async def drive(device, backends):
        rounds = []
        async with ReductServer(device=device) as srv:
            await srv.submit("s", x[:half], d[:half], n_dec=stream.n_dec, v_max=stream.v_max)
            for i in range(5):
                if i:
                    lo, hi = half + (i - 1) * rest // 4, half + i * rest // 4
                    await srv.update("s", x[lo:hi], d[lo:hi])
                solo = [await srv.query("s", "PR", backend=b) for b in backends]
                runs = srv.stats["engine_runs"]
                window = await asyncio.gather(*[srv.query("s", m) for m in DELTAS])
                rounds.append((solo, window, srv.stats["engine_runs"] - runs,
                               [q.batch_size for q in list(srv.requests)[-4:]]))
        return rounds, srv.summary()

    rounds, summary = asyncio.run(drive(cuda_device, ("segment", "sweep", "fused", "pallas")))
    cpu_rounds, _ = asyncio.run(drive("cpu", ("segment",)))
    for (solo, window, runs, sizes), (cpu_solo, cpu_window, _, _) in zip(rounds, cpu_rounds):
        for r in solo[1:]:
            assert (r.reduct, r.theta_history) == (solo[0].reduct, solo[0].theta_history)
        assert runs == 1 and sizes == [4, 4, 4, 4]
        for delta, r, rc in zip(["PR"] + DELTAS, [solo[0]] + window, cpu_solo + cpu_window):
            assert r.reduct == rc.reduct, delta
            if delta == "PR":
                assert r.theta_history == rc.theta_history
            else:
                np.testing.assert_allclose(r.theta_history, rc.theta_history, rtol=1e-5,
                                           atol=1e-7)
            assert r.theta_history[-1] <= f32_threshold(r.theta_full, 1e-6), delta
    for k in ("retries", "stale_served", "quarantined", "flush_failures"):
        assert summary[k] == 0, k


# ---------------------------------------------------------------------------
# the mesh driver on the card (one H100: a world of one NCCL rank)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("delta", DELTAS)
def test_fused_raw_partials_sum_to_unsplit_theta_on_card(cuda_device, delta):
    """The mesh ``fused`` schedule's identity at kdd99 shapes (G = 131,072
    with 24% padding, nc = 41, V = 10, n_dec = 23, K = 4,096 classes):
    a class-grouped granule table split into 4 contiguous parts; the
    kernel's raw partials summed, then scaled once, equal the unsplit
    ``fused_theta`` — Θ_PR bit for bit, the others within the phase-3
    tolerance — and the plain raw version equals the kernel's raw output."""
    G, nc, v, m, k = 131_072, 41, 10, 23, 4_096
    gen = torch.Generator().manual_seed(17)
    r = torch.sort(torch.randint(0, k, (G,), generator=gen, dtype=torch.int32)).values
    x_t = torch.randint(0, v, (nc, G), generator=gen, dtype=torch.int32)
    d = torch.randint(0, m, (G,), generator=gen, dtype=torch.int32)
    w = torch.randint(1, 200, (G,), generator=gen).to(torch.float32)
    w[torch.rand((G,), generator=gen) < 0.24] = 0.0
    packed = (r[None, :] * v + x_t).contiguous()
    cuts = [0] + [int(torch.searchsorted(r, r[c])) for c in (G // 4, G // 2, 3 * G // 4)] + [G]
    packed, d, w = packed.to(cuda_device), d.to(cuda_device), w.to(cuda_device)
    n = torch.tensor(float(w.sum()), device=cuda_device)
    kw = dict(delta=delta, n_bins=k * v, n_dec=m)
    before = ops.launch_counts()["fused_theta"]
    parts = [ops.fused_theta_raw(packed[:, lo:hi].contiguous(), d[lo:hi].contiguous(),
                                 w[lo:hi].contiguous(), **kw) for lo, hi in zip(cuts, cuts[1:])]
    split = ops.theta_scale(delta, parts[0] + parts[1] + parts[2] + parts[3], n)
    whole = ops.fused_theta(packed, d, w, n, **kw)
    raw = ops.fused_theta_raw(packed, d, w, **kw)
    torch.cuda.synchronize()
    assert ops.launch_counts()["fused_theta"] == before + 6
    _close(delta, split, whole)
    _close(delta, raw, ref.fused_theta_raw_ref(packed, d, w, **kw))


@pytest.fixture
def nccl_world(cuda_device, tmp_path):
    """This process as a world of one NCCL rank (FileStore rendezvous)."""
    import torch.distributed as dist

    from repro_torch.distributed import init_process_group

    dev = init_process_group("cuda", rank=0, world_size=1, store_path=str(tmp_path / "store"),
                             timeout_s=120)
    yield dev
    dist.destroy_process_group()


def test_mesh_driver_world_of_one_equals_solo_on_card(nccl_world):
    """Mesh (1, 1) on NCCL: every schedule and engine gives the solo
    reduction's reduct, core and Θ history (PR bit-equal, SCE within
    rtol=1e-6); the device engine captures its body (collectives inside)
    at its first call and replays it at the second; ``fused`` launches the
    kernel every iteration."""
    from repro_torch import obs
    from repro_torch.core.distributed import plar_reduce_distributed
    from repro_torch.distributed import make_mesh

    from repro_torch.data import scaled_paper_dataset

    mesh = make_mesh((1, 1), ("data", "model"), device="cuda")
    x, d = scaled_paper_dataset("mushroom", max_rows=2000, max_attrs=22).table()
    obs.enable()
    try:
        for delta in ("PR", "SCE"):
            solo = plar_reduce(x, d, delta=delta, engine="host", device=nccl_world)
            runs = [("all_reduce", "host", None), ("reduce_scatter", "host", None),
                    ("all_reduce", "device", 1), ("reduce_scatter", "device", 1),
                    ("all_reduce", "device", 0), ("fused", "host", None)]
            for coll, eng, captures in runs:
                before_launch = ops.launch_counts()["fused_theta"]
                before = obs.get_tracer().recorded
                r = plar_reduce_distributed(x, d, mesh, delta=delta, collective=coll, engine=eng)
                assert (r.reduct, r.core) == (solo.reduct, solo.core), (delta, coll, eng)
                if delta == "PR":
                    assert r.theta_history == solo.theta_history
                else:
                    np.testing.assert_allclose(r.theta_history, solo.theta_history,
                                               rtol=1e-6, atol=1e-7)
                if coll == "fused":
                    assert ops.launch_counts()["fused_theta"] - before_launch == r.iterations > 0
                if captures is not None:
                    fresh = obs.get_tracer().recorded - before
                    span = [s for s in obs.get_tracer().records()[-fresh:]
                            if s.name == "engine.dispatch"][-1]
                    assert span.args["captures"] == captures, (delta, coll)
    finally:
        obs.disable()
        engine.release_graphs()


def test_mesh_reduce_scatter_on_nccl_eager_and_captured(nccl_world):
    """The adapter's ``psum_scatter_bins`` (NCCL ``reduce_scatter_tensor``,
    bins moved to dim 0) on a world of one rank, eagerly and inside a CUDA
    graph: the driver's merge takes it only at two or more data shards,
    which one card never has.  One shard keeps every bin, so the output
    equals the input, in the ``[nc, bins, m]`` layout."""
    from repro_torch.core.engine import _MeshColl
    from repro_torch.distributed import make_mesh

    coll = _MeshColl(make_mesh((1, 1), ("data", "model"), device="cuda"))
    gen = torch.Generator(device=nccl_world).manual_seed(5)
    cont = torch.randint(0, 1 << 20, (41, 4_096, 23), generator=gen, device=nccl_world,
                         dtype=torch.int32).to(torch.float32)
    assert torch.equal(coll.psum_scatter_bins(cont.clone()), cont)
    static_in = cont.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        coll.psum_scatter_bins(static_in.clone())
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static_out = coll.psum_scatter_bins(static_in)
    for _ in range(2):
        static_in.copy_(cont)
        graph.replay()
        torch.cuda.synchronize()
        assert static_out.shape == cont.shape
        assert torch.equal(static_out, cont)
        cont = cont + 1


def test_mesh_auto_engine_fits_the_card(nccl_world):
    """``engine="auto"`` takes the device engine where its static working
    set fits the card (phase 12's kdd99 granularity: cap 131,072) and the
    host loop where it does not (the 5,000,000-row x, d table)."""
    from repro_torch.core.distributed import _resolve_engine
    from repro_torch.distributed import make_mesh

    mesh = make_mesh((1, 1), ("data", "model"), device="cuda")
    assert _resolve_engine("auto", "all_reduce", mesh, 41, 131_072, 10, 23) == "device"
    assert _resolve_engine("auto", "all_reduce", mesh, 41, 5_000_000, 10, 23) == "host"
    assert _resolve_engine("auto", "fused", mesh, 41, 131_072, 10, 23) == "host"
    assert _resolve_engine("device", "all_reduce", mesh, 41, 5_000_000, 10, 23) == "device"


# ---------------------------------------------------------------------------
# tile selection: every tiling gives the plain bits; a body's tiles key its runner
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [1, 300])
@pytest.mark.parametrize("n_dec", [2, 23])
@pytest.mark.parametrize("kernel", ["contingency", "fused", "sweep"])
def test_every_feasible_tiling_gives_the_plain_bits(cuda_device, kernel, n_dec, k):
    """Every feasible tiling (``model.feasible_tiles``) at a small shape, its
    segments long and split (k = 1: every granule in one class) or short
    (k = 300): the contingency and Θ_PR bit-equal to the plain version, Θ_SCE
    bit-equal across the tilings and within rtol = 1e-5, atol =
    1e-6·max|plain| of the plain version (its within-tile sum order)."""
    from repro_torch.kernels.contingency import model

    x_t, r, d, w = _operands(cuda_device, 40 + k, nc=9, g=20_000, v=10, k=k, m=n_dec)
    n_bins = 12_000
    packed = (r[None, :] * 10 + x_t).contiguous()
    n = float(w.sum())
    tilings = model.feasible_tiles(kernel, 9, 20_000, n_bins, n_dec)
    assert len(tilings) > 1
    if kernel == "contingency":
        want = ref.contingency_ref(packed, d, w, n_bins=n_bins, n_dec=n_dec)
        for threads, ctas in tilings:
            got = ops.contingency(packed, d, w, n_bins=n_bins, n_dec=n_dec, threads=threads,
                                  ctas=ctas)
            assert torch.equal(got, want), (threads, ctas)
        return
    for delta in ("PR", "SCE"):
        if kernel == "fused":
            want = ref.fused_theta_ref(packed, d, w, n, delta=delta, n_bins=n_bins, n_dec=n_dec)
            run = lambda t: ops.fused_theta(packed, d, w, n, delta=delta, n_bins=n_bins,  # noqa: E731
                                            n_dec=n_dec, chunk=t[0], threads=t[1])
        else:
            want = ref.sweep_theta_ref(x_t, r, d, w, n, delta=delta, v_max=10, n_bins=n_bins,
                                       n_dec=n_dec)
            run = lambda t: ops.sweep_theta(x_t, r, d, w, n, delta=delta, v_max=10,  # noqa: E731
                                            n_bins=n_bins, n_dec=n_dec, bc=t[0], chunk=t[1],
                                            threads=t[2])
        first = None
        for tiles in tilings:
            got = run(tiles)
            first = got if first is None else first
            assert torch.equal(got, first), (delta, tiles)
            if delta == "PR":
                assert torch.equal(got, want), tiles
            else:
                scale = float(want.abs().max())
                assert torch.allclose(got, want, rtol=1e-5, atol=1e-6 * scale), tiles


def test_engine_body_with_other_tiles_is_captured_anew(cuda_device, tmp_path, monkeypatch):
    """The sweep kernel in the device engine's captured body: a tuning
    persisted after the capture gives the next run another runner, captured
    anew with the new tiles (never a replay of the old ones), and both runs
    give the host loop's answer."""
    from repro_torch.kernels.contingency import autotune, model

    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(tmp_path / "autotune.json"))
    autotune.autotune_cache_clear(disk=True)
    x, d = _engine_table(5)
    kw = dict(delta="PR", backend="sweep", grc_init=False, device=cuda_device)
    host = plar_reduce(x, d, engine="host", **kw)
    ops.reset_launch_counts()
    r1 = plar_reduce(x, d, engine="device", **kw)
    assert ops.launch_counts()["sweep_theta"] > 0
    args = ("PR", "incremental", "sweep", 10, 3000, 3, 4, 1e-6, 1e-5, False, 10, 64)
    first = engine.make_engine_run(*args, device=cuda_device)
    assert first.loop.captures == 1
    other = next(t for t in model.feasible_tiles("sweep", 10, 3000, 12_000, 3)
                 if t != first.cfg.tiles)
    autotune._disk_put(autotune._disk_key(autotune.platform_of(cuda_device), "sweep",
                                          autotune.shape_bucket(10, 3000, 12_000, 3)), other)
    r2 = plar_reduce(x, d, engine="device", **kw)
    second = engine.make_engine_run(*args, device=cuda_device)
    assert second is not first and second.cfg.tiles == other
    assert (first.loop.captures, second.loop.captures) == (1, 1)
    assert _same(r1, host) and _same(r2, host)
    autotune.autotune_cache_clear(disk=True)


@pytest.mark.parametrize("rows", [3_000])
def test_sdss_width_on_card_matches_segment_and_cpu(cuda_device, rows):
    """The sdss stand-in at its full width (5,201 attributes, 82 candidate
    chunks an iteration) with its rows cut: the three kernel backends on the
    card give ``segment``'s reduct on the card and on the CPU, and its Θ_PR
    history bit for bit."""
    from repro_torch.core import resolve_granularity
    from repro_torch.data import scaled_paper_dataset

    x, d = scaled_paper_dataset("sdss", max_rows=rows, max_attrs=5_201).table()
    assert x.shape == (rows, 5_201)
    kw = dict(delta="PR", engine="host", compute_core=False)
    gran = resolve_granularity(x, d, device=cuda_device)
    cpu = plar_reduce(x, d, backend="segment", device="cpu", **kw)
    card = plar_reduce(source=gran, backend="segment", device=cuda_device, **kw)
    assert (card.reduct, card.theta_history) == (cpu.reduct, cpu.theta_history)
    for backend, kernel in (("sweep", "sweep_theta"), ("fused", "fused_theta"),
                            ("pallas", "contingency")):
        ops.reset_launch_counts()
        r = plar_reduce(source=gran, backend=backend, device=cuda_device, **kw)
        assert ops.launch_counts()[kernel] >= 82 * r.iterations > 0, backend
        assert (r.reduct, r.theta_history) == (cpu.reduct, cpu.theta_history), backend


@pytest.mark.parametrize("mesh_kind", ["single", "multi"])
def test_dryrun_shard_step_on_nccl_equals_solo(nccl_world, mesh_kind):
    """The dry-run cell's shard step (20,480 or 10,240 x 326) on a world of
    one NCCL rank: every evaluation form's Θ equals the solo evaluation, the
    payloads equal the model's at mesh (1, 1), and ``fused`` launches the
    fused-Θ kernel."""
    from repro_torch.launch import dryrun

    for collective, fused_pack in [("all_reduce", False), ("reduce_scatter", False),
                                   ("all_reduce", True), ("fused", False)]:
        rec = dryrun.run_plar_cell(mesh_kind, collective=collective, fused_pack=fused_pack,
                                   execute=True, device=nccl_world)
        ran = rec["executed"]
        assert rec["status"] == "ok" and ran["theta_equals_solo"], rec
        assert ran["device_ms"] > 0 and ran["advance_ms"] > 0 and ran["peak_bytes"] > 0
        assert ran["peak_over_modelled_temps"] > 0 and ran["reps"] == dryrun.REPS
        assert rec["roofline_spec"] == torch.cuda.get_device_name(nccl_world)  # the card run
        cell = dryrun.PlarCell.production(mesh_kind)
        shard = dryrun.PlarCell(G=cell.g_loc, A=cell.a_loc, n_data=1, n_model=1)
        assert ran["eval_payload_bytes"] == dryrun.model_eval_collectives(
            shard, collective)["total_payload_bytes"]
        assert (ran["launches"]["fused_theta"] > 0) == (collective == "fused")
