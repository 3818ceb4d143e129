"""The port's tile selection (``repro_torch.kernels.contingency.model`` and
``autotune``) on the CPU, mirroring ``tests/test_kernel_cost_model.py``
case for case where the case carries over, and held against the JAX
package where both compute the same thing.

Carried over: ranks deterministic and sorted, feasibility under the spec's
limits, the bc-reuse property, ladder pruning, the selector modes, the
parity matrix over backends, the wrappers' default tiles = analytic, the
caches (platform key, clear/info, bounded LRU, disk round trip, disk over
the model, restricted candidates not persisted) and the refinement (at most
top-k timed, nothing by default, a refused candidate skipped).

Against JAX, on the same inputs: ``prune_ladder_rungs`` and
``ladder_rungs(selector="analytic", g=, m=)`` over a grid of shapes; the
reduct and the Θ_PR history of ``plar_reduce`` under every selector; and a
JAX tuning on disk, under JAX's ``"cpu"`` key, is never read as a tiling
of the port.

Deliberate divergence: the JAX file checks its model's FLOPs and bytes
against XLA's ``compiled.cost_analysis()`` on single-grid-step shapes.  The
port's kernels are CUDA with no compiler here and no cost analysis on the
card, so that check has no counterpart; in its place the model's passes are
held to the wrappers' launch sequences, and ``chip_smoke.py`` phase 16
prints each tiling's modeled time beside its measured one on the card.
"""
import json
import logging

import numpy as np
import pytest
import torch

from repro.core import plar_reduce as j_plar
from repro.core.plan import ladder_rungs as j_ladder_rungs
from repro.kernels.contingency import autotune as j_autotune
from repro.kernels.contingency.model import prune_ladder_rungs as j_prune
from repro.kernels.contingency.model import rung_eval_cost_bytes as j_rung_cost
from repro_torch.core import engine
from repro_torch.core import plan
from repro_torch.core import plar_reduce as t_plar
from repro_torch.kernels.contingency import autotune, model, ops
from repro_torch.kernels.contingency.autotune import (
    SELECTOR_MODES,
    autotune_block_sizes,
    autotune_cache_clear,
    autotune_cache_info,
    resolve_tiles,
    shape_bucket,
)
from repro_torch.kernels.contingency.model import (
    PINNED_TILES,
    TILE_FIELDS,
    KernelCost,
    feasible_tiles,
    kernel_cost,
    modeled_time_s,
    prune_ladder_rungs,
    rank_tiles,
    resident_ctas,
    rung_eval_cost_bytes,
    select_tiles,
    sweep_cost,
)
from repro_torch.launch.roofline import H100_SXM, device_spec

torch.set_num_threads(1)

CPU = "cpu"
KERNELS = ["contingency", "fused", "sweep"]
SHAPE = dict(nc=41, g=131_072, m=23)          # kdd99's candidates, capacity, decisions


@pytest.fixture()
def tmp_disk(tmp_path, monkeypatch):
    path = tmp_path / "autotune.json"
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(path))
    autotune_cache_clear(disk=True)
    yield path
    autotune_cache_clear(disk=True)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kernel,launches", [("contingency", 2), ("fused", 7), ("sweep", 7)])
def test_cost_passes_follow_the_launches(kernel, launches):
    """The model prices each launch of a wrapper call: the contingency's zero
    fill and atomic pass; the Θ kernels' memset, count, plan, scatter, short
    tiles, long tiles and ordered sum (``csrc/*.cu``)."""
    cost = kernel_cost(kernel, 8, 3000, 1024, 5, PINNED_TILES[kernel], v_max=4)
    assert cost.launches == launches
    assert cost.hbm_bytes > 0 and cost.flops >= 0
    assert modeled_time_s(cost) == pytest.approx(
        sum(model.pass_time_s(p) for p in cost.passes))


def test_sweep_bc_reuse_model_property():
    """A segment entry is loaded once a block of bc candidates: a larger bc
    cuts the long tiles' entry loads by exactly the blocks it saves, while
    each candidate's gather and add stays."""
    nc, g, nb, m = 64, 4096, 256, 2
    only = model.Costs(**{f: 0.0 for f in ("short_item", "short_cand", "cell", "long_cand")})
    c1, c8 = (sweep_cost(nc, g, nb, m, bc, 4096, 256, costs=only) for bc in (1, 8))
    l1, l8 = (next(p for p in c.passes if p.name == "long_tiles") for c in (c1, c8))
    entries = model._segments(g, 1, 4096)[3]
    assert l1.cycles - l8.cycles == pytest.approx(entries * (64 - 8) * only.long_entry, rel=1e-9)
    with_cand = model.Costs(**{f: 0.0 for f in ("short_item", "short_cand", "cell")})
    d1, d8 = (next(p for p in sweep_cost(nc, g, nb, m, bc, 4096, 256, costs=with_cand).passes
                   if p.name == "long_tiles") for bc in (1, 8))
    assert d1.cycles - d8.cycles == pytest.approx(l1.cycles - l8.cycles, rel=1e-9)


def test_fit_recovers_the_rates_it_was_given():
    """``launch.fit_tiles`` on times the model itself gives (the default
    rates at kdd99's uniform shapes, fused and sweep) finds rates that give
    them again, within 1%."""
    from repro_torch.launch import fit_tiles

    rows = []
    for n_bins in (160, 1_310_720):
        for kernel in ("fused", "sweep"):
            for tiles in feasible_tiles(kernel, 41, 131_072, n_bins, 23)[::3]:
                row = dict(kernel=kernel, n_bins=n_bins, K=n_bins // 10, tiles=list(tiles))
                row["ms"] = fit_tiles.modeled_s(model.COSTS, row) * 1e3
                rows.append(row)
    fitted = fit_tiles.fit(rows)
    for row in rows:
        assert fit_tiles.modeled_s(fitted, row) * 1e3 == pytest.approx(row["ms"], rel=1e-2)


def test_time_tiles_needs_a_card(monkeypatch):
    from repro_torch.launch import time_tiles

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="needs a CUDA card"):
        time_tiles.main([])


@pytest.mark.parametrize("kernel", KERNELS)
def test_feasible_tiles_respect_the_spec(kernel):
    """Every candidate fits a block of the spec: shared memory within the
    opt-in limit, at most 1,024 threads, one CTA resident per SM; a smaller
    card's spec drops the tilings it cannot hold."""
    small = H100_SXM.__class__(**{**H100_SXM.__dict__, "smem_per_block": 64 * 1024,
                                  "smem_per_sm": 100 * 1024})
    for spec in (H100_SXM, small):
        cands = feasible_tiles(kernel, 41, 3000, 10_240, 23, spec=spec)
        assert cands
        for tiles in cands:
            assert len(tiles) == len(TILE_FIELDS[kernel])
            cost = kernel_cost(kernel, 41, 3000, 10_240, 23, tiles, spec=spec)
            for p in cost.passes:
                assert p.threads <= spec.threads_per_block
                assert p.smem <= spec.smem_per_block
                assert resident_ctas(p.threads, p.smem, p.regs, spec) >= 1
    if kernel == "sweep":   # bc 8 at 23 decisions needs 196,608 bytes of histograms
        assert max(t[0] for t in feasible_tiles(kernel, 41, 3000, 10_240, 23)) == 8
        assert max(t[0] for t in feasible_tiles(kernel, 41, 3000, 10_240, 23, spec=small)) == 2
        # no all-padding candidate block: bc // 2 < nc
        assert {t[0] for t in feasible_tiles(kernel, 2, 3000, 10_240, 23)} == {1, 2}
    if kernel == "contingency":   # no grid cap twice what the pairs need
        for threads, ctas in feasible_tiles(kernel, 2, 300, 40, 3):
            assert ctas == 1 or H100_SXM.sms * (ctas // 2) < -(-600 // threads)


def test_no_feasible_tiling_leaves_the_kernel_to_refuse():
    """A 256-bin histogram of 300 decisions exceeds shared memory: the only
    candidate is the pinned tiling, which the kernel refuses itself."""
    for kernel in ("fused", "sweep"):
        assert feasible_tiles(kernel, 4, 1000, 1024, 300) == (PINNED_TILES[kernel],)


@pytest.mark.parametrize("kernel", KERNELS)
def test_rank_is_deterministic_and_sorted(kernel):
    r1 = rank_tiles(kernel, **SHAPE, n_bins=1_310_720, v_max=10, delta="PR")
    r2 = rank_tiles(kernel, **SHAPE, n_bins=1_310_720, v_max=10, delta="PR")
    assert r1 == r2
    times = [t for _, _, t in r1]
    assert times == sorted(times)
    assert select_tiles(kernel, SHAPE["nc"], SHAPE["g"], 1_310_720, SHAPE["m"], v_max=10,
                        delta="PR") == r1[0][0]
    assert all(isinstance(c, KernelCost) and modeled_time_s(c) == t for _, c, t in r1[:3])


def test_cpu_spec_is_the_fixed_h100_spec():
    """On the CPU the model ranks on a fixed H100 SXM spec: picks are a pure
    function of the shape, whatever machine runs them."""
    assert device_spec(None) is H100_SXM and device_spec("cpu") is H100_SXM
    assert select_tiles("sweep", 41, 131_072, 10_240, 23, v_max=10) == rank_tiles(
        "sweep", 41, 131_072, 10_240, 23, v_max=10, spec=H100_SXM)[0][0]


# ---------------------------------------------------------------------------
# analytic ladder-rung pruning: the JAX package's, exactly
# ---------------------------------------------------------------------------


def test_prune_ladder_rungs_invariants():
    rungs = plan.ladder_rungs(4096)
    pruned = prune_ladder_rungs(rungs, 4096, 8)
    assert set(pruned) <= set(rungs)
    assert pruned[-1] == rungs[-1]
    assert list(pruned) == sorted(pruned)
    assert prune_ladder_rungs((256, 512, 1024), 256, 23) == (256, 512, 1024)


def test_prune_ladder_dispatch_bound_collapse():
    assert prune_ladder_rungs((256, 512), 4096, 128) == (512,)
    assert rung_eval_cost_bytes(256, 4096, 128) < rung_eval_cost_bytes(512, 4096, 128)


def test_ladder_rungs_selector_modes():
    assert plan.ladder_rungs(1024) == (256, 512, 1024)
    pruned = plan.ladder_rungs(4096, selector="analytic", g=4096, m=128)
    full = plan.ladder_rungs(4096)
    assert set(pruned) <= set(full) and pruned[-1] == full[-1]
    assert plan.ladder_rungs(4096, selector="analytic") == full
    for sel in ("heuristic", "pinned"):
        assert plan.ladder_rungs(4096, selector=sel, g=4096, m=128) == full


@pytest.mark.parametrize("n_bins", [40, 256, 1000, 4096, 10_240, 1_310_720])
@pytest.mark.parametrize("g,m", [(16, 2), (300, 3), (4096, 8), (131_072, 23), (5_000, 128)])
def test_ladder_pruning_equals_jax(n_bins, g, m):
    full = plan.ladder_rungs(n_bins)
    assert full == tuple(j_ladder_rungs(n_bins))
    assert prune_ladder_rungs(full, g, m) == tuple(j_prune(full, g, m))
    assert plan.ladder_rungs(n_bins, selector="analytic", g=g, m=m) == tuple(
        j_ladder_rungs(n_bins, selector="analytic", g=g, m=m))
    assert [rung_eval_cost_bytes(r, g, m) for r in full] == [j_rung_cost(r, g, m) for r in full]


# ---------------------------------------------------------------------------
# selector parity: tiles and rungs never change bits
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["segment", "fused_xla", "sweep_xla", "sweep", "fused",
                                     "pallas"])
def test_selector_parity_matrix(backend):
    rng = np.random.default_rng(7)
    x = rng.integers(0, 3, (300, 10)).astype(np.int32)
    d = rng.integers(0, 3, (300,)).astype(np.int32)
    ref = None
    for sel in SELECTOR_MODES:
        r = t_plar(x, d, delta="SCE", backend=backend, ladder=True, selector=sel, device=CPU)
        key = (tuple(r.reduct), tuple(np.float32(t).tobytes() for t in r.theta_history))
        if ref is None:
            ref = key
        assert key == ref, f"selector={sel} backend={backend} changed bits"


@pytest.mark.parametrize("backend,engine_", [("segment", "device"), ("sweep", "host"),
                                             ("fused", "host"), ("pallas", "host"),
                                             ("sweep", "device")])
def test_selectors_give_jax_reducts_and_pr_bits(backend, engine_):
    """Every selector: JAX's reduct, and its Θ_PR history bit for bit."""
    rng = np.random.default_rng(11)
    x = rng.integers(0, 4, (400, 9)).astype(np.int32)
    d = rng.integers(0, 3, (400,)).astype(np.int32)
    want = j_plar(x, d, delta="PR", backend="segment", engine="host", ladder=True)
    for sel in SELECTOR_MODES:
        r = t_plar(x, d, delta="PR", backend=backend, engine=engine_, ladder=True, selector=sel,
                   device=CPU)
        assert (r.reduct, r.core) == (list(want.reduct), list(want.core)), sel
        assert [np.float32(t).tobytes() for t in r.theta_history] == [
            np.float32(t).tobytes() for t in want.theta_history], sel


@pytest.mark.parametrize("kernel", KERNELS)
def test_ops_default_tiles_match_analytic(kernel, tmp_disk):
    """A wrapper's ``None`` fields resolve to the analytic pick; given
    fields are kept."""
    shape = dict(nc=8, g=3000, n_bins=1024, m=5, v_max=4, delta="SCE")
    given = (None,) * len(TILE_FIELDS[kernel])
    want = select_tiles(kernel, 8, 3000, 1024, 5, v_max=4, delta="SCE")
    assert ops.launch_tiles(kernel, given, selector=None, device=CPU, **shape) == want
    pinned = PINNED_TILES[kernel]
    part = (pinned[0],) + (None,) * (len(pinned) - 1)
    got = ops.launch_tiles(kernel, part, selector=None, device=CPU, **shape)
    assert got[0] == pinned[0] and got[1:] == want[1:]
    assert ops.launch_tiles(kernel, pinned, selector="nope", device=CPU, **shape) == pinned


def test_resolve_tiles_modes(tmp_disk):
    kw = dict(nc=8, g=3000, n_bins=1024, m=23)
    for kernel in KERNELS:
        assert resolve_tiles(kernel, **kw, selector="pinned") == PINNED_TILES[kernel]
        assert resolve_tiles(kernel, **kw, selector="heuristic") == (
            autotune.select_block_sizes(1024, 3000, 23, kernel=kernel, nc=8))
        assert resolve_tiles(kernel, **kw) == select_tiles(kernel, 8, 3000, 1024, 23)
    assert PINNED_TILES == {"contingency": (256, 64), "fused": (4096, 256),
                            "sweep": (4, 4096, 256)}      # the kernels' earlier fixed launch shapes
    assert plan.SELECTOR_MODES == SELECTOR_MODES
    with pytest.raises(ValueError, match="unknown tile selector"):
        resolve_tiles("fused", **kw, selector="nope")
    with pytest.raises(ValueError, match="unknown kernel"):
        resolve_tiles("onehot", **kw)
    with pytest.raises(ValueError, match="unknown tile selector"):
        ops.sweep_theta(torch.zeros((1, 4), dtype=torch.int32),
                        *(torch.zeros(4, dtype=torch.int32),) * 2, torch.ones(4), 4.0,
                        delta="PR", v_max=2, n_bins=8, n_dec=2, selector="nope")


def test_heuristic_bc_follows_shared_memory():
    """The heuristic's bc: the largest that leaves two long CTAs an SM."""
    assert autotune.select_block_sizes(10_240, 131_072, 23, kernel="sweep", nc=41)[0] == 4
    assert autotune.select_block_sizes(10_240, 131_072, 2, kernel="sweep", nc=41)[0] == 8
    assert autotune.select_block_sizes(10_240, 131_072, 2, kernel="sweep", nc=3)[0] == 4
    assert autotune.select_block_sizes(10_240, 131_072, 60, kernel="sweep", nc=41)[0] == 1


# ---------------------------------------------------------------------------
# caches: platform key, LRU bound, disk round trip, and JAX's file kept apart
# ---------------------------------------------------------------------------


def test_cache_key_includes_platform(tmp_disk):
    shape = dict(nc=2, g=256, n_bins=64, m=8)
    autotune_block_sizes(**shape)
    info0 = autotune_cache_info()
    autotune_block_sizes(**shape, platform="NVIDIA H100 80GB HBM3")
    info1 = autotune_cache_info()
    assert info1["misses"] == info0["misses"] + 1
    autotune_block_sizes(**shape, platform="NVIDIA H100 80GB HBM3")
    assert autotune_cache_info()["hits"] == info1["hits"] + 1
    keys = json.loads(tmp_disk.read_text())
    assert set(keys) == {"repro_torch|cpu|contingency|2x256x64x8",
                         "repro_torch|NVIDIA H100 80GB HBM3|contingency|2x256x64x8"}


def test_cache_clear_and_info(tmp_disk):
    autotune_block_sizes(2, 256, 64, 8)
    info = autotune_cache_info()
    assert info["size"] >= 1 and info["disk_entries"] >= 1
    assert info["disk_path"] == str(tmp_disk)
    autotune_cache_clear(disk=True)
    info = autotune_cache_info()
    assert info["size"] == 0 and info["hits"] == 0 and info["misses"] == 0
    assert info["disk_entries"] == 0 and not tmp_disk.exists()


def test_cache_lru_bounded(tmp_disk, monkeypatch):
    monkeypatch.setattr(autotune, "_CACHE_MAXSIZE", 4)
    autotune_cache_clear()
    for i in range(8):
        autotune_block_sizes(2, 256 + 128 * i, 64, 8)
    assert autotune_cache_info()["size"] <= 4


def test_disk_cache_roundtrip(tmp_disk):
    pick = autotune_block_sizes(2, 300, 40, 3, kernel="sweep", v_max=4)
    assert tmp_disk.exists()
    data = json.loads(tmp_disk.read_text())
    key = autotune._disk_key("cpu", "sweep", shape_bucket(2, 300, 40, 3))
    assert tuple(data[key]) == pick
    autotune_cache_clear()
    autotune._disk_state["data"] = None                 # a fresh process
    assert resolve_tiles("sweep", nc=2, g=300, n_bins=40, m=3, v_max=4) == pick


def test_disk_tuned_overrides_model(tmp_disk):
    kw = dict(nc=8, g=3000, n_bins=1024, m=23)
    model_pick = select_tiles("fused", 8, 3000, 1024, 23)
    custom = (16384, 1024)
    assert custom != model_pick
    key = autotune._disk_key("cpu", "fused", shape_bucket(8, 3000, 1024, 23))
    tmp_disk.write_text(json.dumps({key: list(custom)}))
    autotune._disk_state["data"] = None
    assert resolve_tiles("fused", **kw) == custom
    assert resolve_tiles("fused", **kw, selector="heuristic") != custom
    assert resolve_tiles("fused", **kw, selector="pinned") == PINNED_TILES["fused"]
    # an entry of the wrong arity is no tiling of this kernel
    tmp_disk.write_text(json.dumps({key: [8, 128, 256]}))
    autotune._disk_state["data"] = None
    assert resolve_tiles("fused", **kw) == model_pick


def test_jax_tuning_is_never_read_by_the_port(tmp_path, monkeypatch):
    """JAX persists a TPU tiling under its ``"cpu"`` key; the port, pointed
    at the same file and the same shape, still takes its own model's pick
    (its keys carry the ``repro_torch`` prefix), and its own file is another."""
    shared = tmp_path / "shared.json"
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(shared))
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(shared))
    j_autotune.autotune_cache_clear(disk=True)
    autotune_cache_clear()
    autotune._disk_state["data"] = None
    try:
        j_pick = j_autotune.autotune_block_sizes(2, 300, 40, 3, delta="SCE")
        assert json.loads(shared.read_text()) == {
            "cpu|fused|2x512x64x4": list(j_pick)}
        j_autotune._disk_put("cpu|fused|2x512x64x4", (4096, 256))   # the port's arity, even
        autotune._disk_state["data"] = None
        assert resolve_tiles("fused", nc=2, g=300, n_bins=40, m=3) == select_tiles(
            "fused", 2, 300, 40, 3)
        assert autotune_cache_info()["disk_entries"] == 0
    finally:
        j_autotune.autotune_cache_clear(disk=True)
        autotune_cache_clear()
        autotune._disk_state["data"] = None
    monkeypatch.delenv("REPRO_TORCH_AUTOTUNE_CACHE")
    monkeypatch.delenv("REPRO_AUTOTUNE_CACHE")
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "xdg"))
    assert autotune._disk_path() == tmp_path / "xdg" / "repro-torch-plar" / "autotune.json"
    assert autotune._disk_path() != j_autotune._disk_path()


def test_restricted_candidates_not_persisted(tmp_disk):
    autotune_block_sizes(2, 300, 40, 3, delta="SCE", candidates=((4096, 256), (1024, 128)))
    assert not tmp_disk.exists()


def test_engine_runner_key_holds_the_resolved_tiles(tmp_disk):
    """The device engine's runner is keyed on its body's resolved tiles: a
    tuning persisted after a runner was made gives another runner (captured
    anew on a card), and the plain backends, which launch no kernel, key on
    ``()`` whatever the selector."""
    args = ("PR", "incremental", "sweep", 7, 96, 3, 4, 1e-6, 1e-5, False, 7)
    pinned = engine.make_engine_run(*args, selector="pinned")
    assert pinned.cfg.tiles == PINNED_TILES["sweep"]
    first = engine.make_engine_run(*args)
    assert first.cfg.tiles == select_tiles("sweep", 7, 96, 96 * 4, 3, v_max=4, delta="PR")
    assert engine.make_engine_run(*args) is first
    other = next(t for t in feasible_tiles("sweep", 7, 96, 384, 3) if t != first.cfg.tiles)
    key = autotune._disk_key("cpu", "sweep", shape_bucket(7, 96, 384, 3))
    tmp_disk.write_text(json.dumps({key: list(other)}))
    autotune._disk_state["data"] = None
    tuned = engine.make_engine_run(*args)
    assert tuned is not first and tuned.cfg.tiles == other
    plain = ("PR", "incremental", "segment", 7, 96, 3, 4, 1e-6, 1e-5, False, 7)
    assert engine.make_engine_run(*plain, selector="pinned").cfg.tiles == ()


# ---------------------------------------------------------------------------
# measured refinement: top-k, nothing by default, refused candidates skipped
# ---------------------------------------------------------------------------


def test_refine_times_at_most_topk(tmp_disk, monkeypatch):
    built = []

    def fake_build(kernel, tiles, *a, **kw):
        built.append(tiles)
        return lambda: None

    monkeypatch.setattr(autotune, "_build_candidate_fn", fake_build)
    pick = autotune_block_sizes(4, 2000, 512, 16, delta="SCE", refine=True, reps=1, top_k=3)
    assert len(built) <= 3
    assert pick in built
    assert len(feasible_tiles("fused", 4, 2000, 512, 16)) > 3


def test_refine_default_times_nothing(tmp_disk, monkeypatch):
    def boom(*a, **kw):  # pragma: no cover - must not be reached
        raise AssertionError("refine=False must never launch a candidate")

    monkeypatch.setattr(autotune, "_build_candidate_fn", boom)
    pick = autotune_block_sizes(4, 2000, 512, 16, delta="SCE")
    assert pick == select_tiles("fused", 4, 2000, 512, 16)


def test_refine_skips_a_refused_launch(tmp_disk, monkeypatch, caplog):
    calls = []

    def flaky_build(kernel, tiles, *a, **kw):
        calls.append(tiles)
        if len(calls) == 1:
            def refused():
                raise RuntimeError("sweep_theta kernel launch: CUDA error 1 (invalid argument)")
            return refused
        return lambda: None

    monkeypatch.setattr(autotune, "_build_candidate_fn", flaky_build)
    with caplog.at_level(logging.WARNING, logger="repro_torch.kernels.contingency.autotune"):
        pick = autotune_block_sizes(4, 2000, 512, 16, kernel="sweep", v_max=4, refine=True,
                                    reps=1, top_k=2)
    assert pick == calls[1]
    assert any("refused" in r.message for r in caplog.records)


@pytest.mark.parametrize("kernel", KERNELS)
def test_refine_on_the_cpu_times_the_plain_version(kernel, tmp_disk):
    """On the CPU the timed calls are the plain versions (the mechanism, not
    a speed); the pick is one of the model's top-k and is persisted."""
    ranked = [t for t, _, _ in rank_tiles(kernel, 3, 500, 64, 3, v_max=4)]
    pick = autotune_block_sizes(3, 500, 64, 3, kernel=kernel, v_max=4,
                                delta=None if kernel == "contingency" else "PR",
                                refine=True, reps=1, top_k=2)
    assert pick in ranked[:2]
    assert autotune_cache_info()["disk_entries"] == 1
