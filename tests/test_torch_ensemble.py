"""The port's stacked ensemble engine (``repro_torch.core.plar_reduce_ensemble``)
on the CPU: each member equals its solo ``plar_reduce(engine="device")``
byte for byte (reduct, core, Θ history, iterations, evaluations), and equals
the JAX package's ensemble member (reducts, cores, iterations and
evaluations equal, Θ_PR bit-equal, SCE/LCE/CCE within rtol=1e-6,
atol=1e-7).  Bags are numpy's ``default_rng`` draws, array for array the
JAX package's.

Mirrors ``tests/test_ensemble.py``, its two service tests included
(``DatasetHandle.reduce_ensemble`` and ``ReductServer.query_ensemble``,
each held against the JAX package's service on the same table).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import bagged_weights as j_bagged
from repro.core.reduction import partition_reduce_params as j_partition
from repro.core import plar_reduce_ensemble as j_ensemble
from repro.core import resolve_granularity as j_resolve
from repro_torch import obs
from repro_torch.core import engine
from repro_torch.core import (
    ENSEMBLE_BACKENDS,
    bagged_weights,
    expand_ensemble_grid,
    make_ensemble_run,
    normalize_ensemble_configs,
    partition_reduce_params,
    plar_reduce,
    plar_reduce_ensemble,
    resolve_granularity,
)

# The tensors here are tiny: PyTorch's intra-op thread pool only adds
# overhead, and across pytest-xdist workers it oversubscribes the cores.
torch.set_num_threads(1)

DELTAS = ["PR", "SCE", "LCE", "CCE"]
CPU = "cpu"


def _table(rng, n, a, vmax=4, m=2, redundancy=0.5):
    x = rng.integers(0, vmax, size=(n, a)).astype(np.int32)
    for j in range(1, a):
        if rng.random() < redundancy:
            x[:, j] = x[:, rng.integers(0, j)]
    d = rng.integers(0, m, size=(n,)).astype(np.int32)
    return x, d


def _assert_member(r_e, r_s):
    assert r_e.reduct == r_s.reduct
    assert r_e.theta_history == r_s.theta_history  # bit-identical floats
    assert r_e.core == r_s.core
    assert r_e.theta_full == r_s.theta_full
    assert r_e.iterations == r_s.iterations
    assert r_e.n_evaluations == r_s.n_evaluations


def _assert_jax(delta, rt, rj):
    assert (rt.reduct, rt.core, rt.iterations, rt.n_evaluations) == (
        rj.reduct, rj.core, rj.iterations, rj.n_evaluations)
    if delta == "PR":
        assert rt.theta_history == rj.theta_history
        assert rt.theta_full == rj.theta_full
    else:
        np.testing.assert_allclose(rt.theta_history, rj.theta_history, rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(rt.theta_full, rj.theta_full, rtol=1e-6, atol=1e-7)


MIXED_GRID = [
    {"delta": "PR"},
    {"delta": "SCE", "shrink": True},
    {"delta": "LCE", "max_features": 3, "compute_core": False},
    {"delta": "CCE", "tol": 1e-5},
    {"delta": "PR", "shrink": True, "tie_tol": 1e-4},
    {"delta": "SCE", "warm_start": [1, 2]},
]


def test_ensemble_mixed_grid_matches_sequential_and_jax():
    """One stacked loop over a grid mixing every per-config knob == the same
    configs run solo, member for member, and == JAX's ensemble members."""
    x, d = _table(np.random.default_rng(7), 300, 8, m=3)
    ens = plar_reduce_ensemble(x, d, configs=MIXED_GRID, device=CPU)
    assert len(ens) == len(MIXED_GRID)
    for c, r_e, r_j in zip(MIXED_GRID, ens, j_ensemble(x, d, configs=MIXED_GRID)):
        _assert_member(r_e, plar_reduce(x, d, engine="device", device=CPU, **c))
        _assert_jax(c["delta"], r_e, r_j)


@pytest.mark.parametrize("mode,backend,ladder", [
    ("incremental", "segment", False),
    ("incremental", "onehot", False),
    ("incremental", "sweep_xla", False),
    ("incremental", "sweep_xla", True),
    ("spark", "segment", False),
])
def test_ensemble_backend_parity(mode, backend, ladder):
    x, d = _table(np.random.default_rng(13), 250, 7, m=3)
    ens = plar_reduce_ensemble(x, d, configs=DELTAS, mode=mode, backend=backend,
                               ladder=ladder, device=CPU)
    for dd, r_e in zip(DELTAS, ens):
        _assert_member(r_e, plar_reduce(x, d, delta=dd, engine="device", mode=mode,
                                        backend=backend, ladder=ladder, device=CPU))


def test_ensemble_bagged_matches_reweighted_sequential_and_jax():
    """A ``seed`` config is a bootstrap reweighting of the shared
    granularity: its solo twin is ``plar_reduce`` with ``w`` replaced."""
    x, d = _table(np.random.default_rng(29), 280, 7, m=3)
    gran = resolve_granularity(x, d, device=CPU)
    seeds = [0, 1, 2]
    ens = plar_reduce_ensemble(source=gran, configs=["SCE"], seeds=seeds, device=CPU)
    jens = j_ensemble(source=j_resolve(x, d), configs=["SCE"], seeds=seeds)
    for s, r_e, r_j in zip(seeds, ens, jens):
        w_s = torch.from_numpy(bagged_weights(gran, s))
        assert int(w_s.sum()) == int(gran.n_total)  # total mass preserved
        twin = dataclasses.replace(gran, w=w_s, n_total=w_s.sum().to(torch.int32))
        _assert_member(r_e, plar_reduce(source=twin, delta="SCE", engine="device",
                                        device=CPU))
        _assert_jax("SCE", r_e, r_j)


@pytest.mark.parametrize("seed", [0, 1, 5, 123])
def test_bagged_weights_equal_jax(seed):
    x, d = _table(np.random.default_rng(31), 400, 6, m=3)
    w = bagged_weights(resolve_granularity(x, d, device=CPU), seed)
    assert w.dtype == np.int32
    assert np.array_equal(w, np.asarray(j_bagged(j_resolve(x, d), seed)))


def test_ensemble_one_factory_per_grid():
    """The whole grid is one runner (one CUDA graph on a card), and a second
    grid on different same-shape data makes no new one."""
    n, a, vmax, m = 160, 8, 3, 2
    # a grid no other test uses (tol 2e-6), so the first call is a genuine miss
    grid = [{"delta": dd, "shrink": s, "tol": 2e-6} for dd in DELTAS for s in (False, True)]
    rng = np.random.default_rng(23)
    tables = [_table(rng, n, a, vmax=vmax, m=m) for _ in range(2)]
    for x, d in tables:   # pin v_max/n_dec: both tables resolve to one static config
        x[0, :] = vmax - 1
        d[0] = m - 1

    def factories():
        return obs.get_registry().snapshot().get("plar_engine_ensemble_factories_total", 0)

    before = factories()
    results = [plar_reduce_ensemble(x, d, configs=grid, grc_init=False, device=CPU)
               for x, d in tables]
    assert factories() == before + 1
    runner = make_ensemble_run("incremental", "segment", [c["delta"] for c in grid], a, n, m,
                               vmax, 64, False)
    assert factories() == before + 1                 # the same cached runner
    assert runner.cfg.n_cfgs == len(grid)
    for (x, d), rs in zip(tables, results):
        for c, r_e in zip(grid, rs):
            _assert_member(r_e, plar_reduce(x, d, engine="device", grc_init=False,
                                            device=CPU, **c))


def test_expand_ensemble_grid_order_and_seeds():
    grid = expand_ensemble_grid(["PR", {"delta": "SCE", "shrink": True}], seeds=[4, 9])
    # configs outer, seeds inner; bare measure name → {"delta": name}
    assert grid == [
        {"delta": "PR", "seed": 4}, {"delta": "PR", "seed": 9},
        {"delta": "SCE", "shrink": True, "seed": 4},
        {"delta": "SCE", "shrink": True, "seed": 9},
    ]
    assert expand_ensemble_grid(["LCE"]) == [{"delta": "LCE"}]


def test_partition_reduce_params_matches_jax():
    queries = [
        ("PR", {}), ("SCE", {"shrink": True, "backend": "sweep_xla", "ladder": True}),
        ("LCE", {"backend": "sweep"}), ("CCE", {"ladder": True}), ("XXX", {}),
        ("PR", {"engine": "host"}), ("SCE", {"mode": "spark", "mp_chunk": 8, "seed": 3}),
        ("PR", {"mode": "bogus"}),
    ]
    for delta, params in queries:
        assert partition_reduce_params(delta, params) == j_partition(delta, params)


def test_ensemble_validation_errors():
    x, d = _table(np.random.default_rng(5), 60, 4)
    with pytest.raises(ValueError, match="non-empty"):
        plar_reduce_ensemble(x, d, configs=[], device=CPU)
    with pytest.raises(ValueError, match="unknown measure"):
        plar_reduce_ensemble(x, d, configs=["XXX"], device=CPU)
    with pytest.raises(ValueError, match="unknown ensemble config keys"):
        plar_reduce_ensemble(x, d, configs=[{"delta": "PR", "bogus": 1}], device=CPU)
    with pytest.raises(ValueError, match="seed"):
        # per-config seed and a seeds= grid are mutually exclusive
        normalize_ensemble_configs([{"delta": "PR", "seed": 3}], seeds=[1])
    with pytest.raises(ValueError, match="backend"):
        plar_reduce_ensemble(x, d, configs=["PR"], backend="fused_xla", device=CPU)
    with pytest.raises(ValueError, match="sweep_xla"):
        # the stacked ladder shares one rung across configs — sweep_xla only
        plar_reduce_ensemble(x, d, configs=["PR"], backend="segment", ladder=True,
                             device=CPU)
    with pytest.raises(ValueError, match="out of range"):
        plar_reduce_ensemble(x, d, configs=[{"delta": "PR", "warm_start": [9]}], device=CPU)
    assert "fused_xla" not in ENSEMBLE_BACKENDS


# ---------------------------------------------------------------------------
# service layer
# ---------------------------------------------------------------------------


def test_handle_reduce_ensemble_members_match_direct():
    """DatasetHandle.reduce_ensemble == the driver on the handle's
    granularity, members land in the handle's result cache, and each member
    equals the JAX handle's."""
    from repro.service import DatasetHandle as JHandle
    from repro_torch.service import DatasetHandle

    rng = np.random.default_rng(17)
    x, d = _table(rng, 300, 8, m=3)
    h = DatasetHandle.create(x, d, n_dec=3, v_max=4, device=CPU)
    configs = [{"delta": dd} for dd in DELTAS]
    rs = h.reduce_ensemble(configs)
    direct = plar_reduce_ensemble(source=h.gran, configs=configs, device=CPU)
    for r_h, r_d in zip(rs, direct):
        _assert_member(r_h, r_d)
    assert set(h._results) == {(dd, (("exact", True),)) for dd in DELTAS}
    jrs = JHandle.create(x, d, n_dec=3, v_max=4).reduce_ensemble(configs)
    for dd, r_h, r_j in zip(DELTAS, rs, jrs):
        _assert_jax(dd, r_h, r_j)


def test_server_query_ensemble_cache_and_stats():
    """query_ensemble: cold grid → C cold configs; repeat → pure cache hit;
    overlapping grid → only the new configs re-run (as a smaller grid); the
    counters and answers are the JAX server's."""
    import asyncio

    from repro.service import ReductServer as JServer
    from repro_torch.service import ReductServer

    rng = np.random.default_rng(31)
    x, d = _table(rng, 240, 7, m=3)

    async def drive(srv):
        async with srv:
            await srv.submit("t", x, d, n_dec=3, v_max=4)
            r1 = await srv.query_ensemble("t", ["PR", "SCE"])
            r2 = await srv.query_ensemble("t", ["PR", "SCE"])
            r3 = await srv.query_ensemble("t", ["PR", "SCE", "LCE"])
            return r1, r2, r3, dict(srv.stats), list(srv.requests)

    r1, r2, r3, stats, reqs = asyncio.run(drive(ReductServer(device=CPU)))
    assert [r.reduct for r in r1] == [r.reduct for r in r2]
    assert [r.reduct for r in r3[:2]] == [r.reduct for r in r1]
    assert stats["ensemble_queries"] == 3
    assert stats["ensemble_configs"] == 7
    assert stats["cold"] == 3            # PR, SCE once + LCE once
    assert stats["cache_hits"] == 4      # r2's two + r3's two
    assert not reqs[0].cached and reqs[1].cached and not reqs[2].cached
    _j1, _j2, j3, jstats, _jreqs = asyncio.run(drive(JServer()))
    assert stats == jstats
    for dd, r_t, r_j in zip(["PR", "SCE", "LCE"], r3, j3):
        _assert_jax(dd, r_t, r_j)


# ---------------------------------------------------------------------------
# one runner: the solo engine is the stacked engine of one config
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["segment", "onehot", "fused_xla", "sweep_xla"])
@pytest.mark.parametrize("delta", ["PR", "SCE"])
@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
def test_solo_engine_is_the_stacked_engine_of_one_config(backend, delta, warm):
    """The solo runner and a stacked runner of the one config give the same
    reduct, Θ history, iterations and evaluations, bit for bit: cold (the
    core forced) and warm (a prefix, seeded and resumed in the solo run,
    forced in the stacked one).  Both equal the host loop."""
    x, d = _table(np.random.default_rng(41), 220, 8, m=3)
    gran = resolve_granularity(x, d, device=CPU)
    host = plar_reduce(source=gran, delta=delta, backend=backend, engine="host", device=CPU)
    a, cap, m, v = gran.n_attrs, gran.capacity, gran.n_dec, gran.v_max
    forced = host.reduct[: len(host.reduct) // 2 + 1] if warm else host.core
    solo = engine.run_engine(
        engine.make_engine_run(delta, "incremental", backend, a, cap, m, v, 1e-6, 1e-5, False, a),
        cap, a, gran.valid, gran.x, gran.d, gran.w, gran.n_total, host.theta_full,
        [] if warm else forced, warm_start=forced if warm else None)
    core_attrs = np.zeros((1, a), np.int32)
    core_attrs[0, : len(forced)] = forced
    ops = engine.EnsembleOperands(
        tol=torch.tensor([1e-6]), tie_tol=torch.tensor([1e-5]),
        max_sel=torch.tensor([a], dtype=torch.int32), shrink=torch.tensor([False]),
        theta_full=torch.tensor([host.theta_full]), n=gran.n_total.reshape(1),
        w=gran.w[None], core_attrs=torch.from_numpy(core_attrs),
        core_count=torch.tensor([len(forced)], dtype=torch.int32))
    stacked = engine._runner(engine._Cfg((delta,), "incremental", backend, a, cap, m, v, 64))
    fin, _loop_s = engine.run_ensemble(stacked, cap, a, gran.valid, gran.x, gran.d, ops)
    (reduct, hist, iters, n_evals), = engine.unpack_ensemble_result(fin, [len(forced)])
    assert (reduct, hist, iters, n_evals) == tuple(solo[:4])
    assert (reduct, hist) == (host.reduct, host.theta_history)


def test_ensemble_candidate_scores_go_through_engine_candidate_theta(monkeypatch):
    """The stacked body looks ``candidate_theta`` up in ``core.engine`` at
    call time with the packed ids (the seam the ensemble cell's score tool
    patches): a patched wrapper sees every member's candidates."""
    x, d = _table(np.random.default_rng(43), 200, 7, m=3)
    base = plar_reduce_ensemble(x, d, configs=DELTAS, device=CPU)
    inner, seen = engine.candidate_theta, []

    def candidate_theta(delta, packed, d_, w, valid, n, **kw):
        seen.append((delta, packed.shape[0], kw["n_bins"], kw["m"]))
        return inner(delta, packed, d_, w, valid, n, **kw)
    monkeypatch.setattr(engine, "candidate_theta", candidate_theta)
    ens = plar_reduce_ensemble(x, d, configs=DELTAS, device=CPU)
    for r_e, r_b in zip(ens, base):
        _assert_member(r_e, r_b)
    assert {s[0] for s in seen} == set(DELTAS)
    assert all(nc == 7 for _delta, nc, _nb, _m in seen)
