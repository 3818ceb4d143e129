"""The port's device-resident engine (repro_torch.core.engine) on the CPU,
against the JAX package's device engine and against the port's host loop.

The same seeded numpy tables go through both packages.  Against JAX:
reducts, cores, iterations and ``n_evaluations`` equal, Θ_PR histories and
``theta_full`` bit-equal, SCE/LCE/CCE within rtol=1e-6, atol=1e-7 (as in
``test_torch_reduction.py``).  Inside the port: the device engine and the
host loop give bit-identical Θ histories across measures × shrink × spark ×
ladder, and the result does not depend on the poll period P.  On the CPU
the engine's body runs eagerly; the card tests (``test_torch_cuda.py``)
replay it as a CUDA graph.

Mirrors ``tests/test_engine.py`` except its two mesh tests (the mesh driver
is not ported).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import fspa_reduce as j_fspa
from repro.core import har_reduce as j_har
from repro.core import plar_reduce as j_plar
from repro.core.oracle import reduct_oracle
from repro_torch import obs
from repro_torch.core import engine, plan, reduction
from repro_torch.core import fspa_reduce as t_fspa
from repro_torch.core import har_reduce as t_har
from repro_torch.core import plar_reduce as t_plar

# The tensors here are tiny: PyTorch's intra-op thread pool only adds
# overhead, and across pytest-xdist workers it oversubscribes the cores.
torch.set_num_threads(1)

DELTAS = ["PR", "SCE", "LCE", "CCE"]
CPU = "cpu"


def _table(rng, n, a, vmax=3, m=2, redundancy=0.5):
    x = rng.integers(0, vmax, size=(n, a)).astype(np.int32)
    for j in range(a):
        if rng.random() < redundancy and j > 0:
            x[:, j] = x[:, rng.integers(0, j)]
    d = rng.integers(0, m, size=(n,)).astype(np.int32)
    return x, d


def _pinned_table(seed, n, a, vmax=3, m=2):
    """A table whose v_max and n_dec are pinned, so that every seed resolves
    to the same static config (one runner)."""
    x, d = _table(np.random.default_rng(seed), n, a, vmax=vmax, m=m)
    x[0, :] = vmax - 1
    d[0] = m - 1
    return x, d


def _assert_jax(delta, rt, rj):
    assert rt.reduct == rj.reduct
    assert rt.core == rj.core
    assert rt.iterations == rj.iterations
    assert rt.n_evaluations == rj.n_evaluations
    assert len(rt.theta_history) == len(rj.theta_history)
    if delta == "PR":
        assert rt.theta_history == rj.theta_history          # bit-identical floats
        assert rt.theta_full == rj.theta_full
    else:
        np.testing.assert_allclose(rt.theta_history, rj.theta_history, rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(rt.theta_full, rj.theta_full, rtol=1e-6, atol=1e-7)


def _assert_same(rh, rd):
    """Device engine vs host loop inside the port: bit for bit."""
    assert rh.reduct == rd.reduct
    assert rh.core == rd.core
    assert rh.theta_history == rd.theta_history
    assert rh.theta_full == rd.theta_full
    assert rh.iterations == rd.iterations
    # the device engine evaluates all A candidates per iteration (masked
    # argmin), the host loop only the shrinking remaining set
    assert rd.n_evaluations >= rh.n_evaluations


@pytest.mark.parametrize("delta", DELTAS)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_engine_parity_all_measures(delta, seed):
    x, d = _table(np.random.default_rng(seed), 180, 8)
    rd = t_plar(x, d, delta=delta, engine="device", device=CPU)
    _assert_jax(delta, rd, j_plar(x, d, delta=delta, engine="device"))
    _assert_same(t_plar(x, d, delta=delta, engine="host", device=CPU), rd)
    assert rd.reduct == reduct_oracle(delta, x, d)


@pytest.mark.parametrize("delta", DELTAS)
def test_engine_parity_shrink(delta):
    """FSPA shrinking folds into the state (active mask + PR scalar)."""
    x, d = _table(np.random.default_rng(7), 200, 8)
    rd = t_plar(x, d, delta=delta, shrink=True, engine="device", device=CPU)
    _assert_jax(delta, rd, j_plar(x, d, delta=delta, shrink=True, engine="device"))
    _assert_same(t_plar(x, d, delta=delta, shrink=True, engine="host", device=CPU), rd)


def test_engine_parity_max_features_and_no_core():
    x, d = _table(np.random.default_rng(11), 200, 10, redundancy=0.0)
    for kw in [dict(max_features=3, compute_core=False), dict(compute_core=False)]:
        rd = t_plar(x, d, delta="SCE", engine="device", device=CPU, **kw)
        _assert_jax("SCE", rd, j_plar(x, d, delta="SCE", engine="device", **kw))
        _assert_same(t_plar(x, d, delta="SCE", engine="host", device=CPU, **kw), rd)
        if "max_features" in kw:
            assert len(rd.reduct) <= 3


@pytest.mark.parametrize("delta", ["PR", "SCE"])
def test_engine_parity_spark_mode_and_baselines(delta):
    """HAR/FSPA (mode='spark', no GrC) run on the same engine body, with the
    R-fingerprints kept in the state (dyn_column_terms of each pick)."""
    x, d = _table(np.random.default_rng(13), 150, 7)
    for t_fn, j_fn in ((t_har, j_har), (t_fspa, j_fspa)):
        rd = t_fn(x, d, delta=delta, engine="device", device=CPU)
        _assert_jax(delta, rd, j_fn(x, d, delta=delta, engine="device"))
        _assert_same(t_fn(x, d, delta=delta, engine="host", device=CPU), rd)


def test_engine_auto_resolution_and_validation():
    x, d = _table(np.random.default_rng(17), 80, 5)
    # auto == device for the device backends: the same run
    r_auto = t_plar(x, d, delta="SCE", device=CPU)
    r_dev = t_plar(x, d, delta="SCE", engine="device", device=CPU)
    assert (r_auto.reduct, r_auto.theta_history, r_auto.n_evaluations) == (
        r_dev.reduct, r_dev.theta_history, r_dev.n_evaluations)
    assert r_auto.n_evaluations == j_plar(x, d, delta="SCE").n_evaluations
    # auto == host for the kernel backends: the host loop's evaluation count
    r_kern = t_plar(x, d, delta="SCE", backend="sweep", device=CPU)
    assert r_kern.n_evaluations == j_plar(x, d, delta="SCE", engine="host").n_evaluations
    with pytest.raises(ValueError, match="unknown engine"):
        t_plar(x, d, engine="gpu", device=CPU)
    # engine="device" runs a kernel backend on the engine (auto never does):
    # the host loop's reduct and Θ history, bit for bit
    host = t_plar(x, d, delta="SCE", engine="host", device=CPU)
    for backend in ("pallas", "fused", "sweep"):
        r = t_plar(x, d, delta="SCE", backend=backend, engine="device", device=CPU)
        assert (r.reduct, r.core, r.theta_history) == (host.reduct, host.core,
                                                        host.theta_history), backend


def test_unknown_mode_and_backend_raise():
    x, d = _table(np.random.default_rng(19), 50, 4)
    with pytest.raises(ValueError, match="unknown mode.*incremental.*spark"):
        t_plar(x, d, mode="sprak", device=CPU)
    with pytest.raises(ValueError, match="unknown Θ backend.*segment"):
        t_plar(x, d, backend="sgement", device=CPU)


def _factories():
    return obs.get_registry().snapshot().get("plar_engine_run_factories_total", 0)


def test_engine_one_factory_per_config():
    """The whole reduction is one runner per config (one CUDA graph on a
    card), and a second run on different same-shape data makes no new one."""
    n, a = 160, 8
    x1, d1 = _pinned_table(23, n, a)
    x2, d2 = _pinned_table(24, n, a)
    # grc_init=False ⇒ capacity == n exactly, so the runner's key is known;
    # tol 3e-6 is a config no other test uses
    kw = dict(delta="SCE", engine="device", grc_init=False, tol=3e-6, device=CPU)
    before = _factories()
    r1 = t_plar(x1, d1, **kw)
    runner = engine.make_engine_run("SCE", "incremental", "segment", a, n, 2, 3, 3e-6, 1e-5,
                                    False, a, 64)
    assert _factories() == before + 1
    r2 = t_plar(x2, d2, **kw)
    assert _factories() == before + 1
    assert engine.make_engine_run("SCE", "incremental", "segment", a, n, 2, 3, 3e-6, 1e-5,
                                  False, a, 64) is runner
    assert r1.reduct == reduct_oracle("SCE", x1, d1)
    assert r2.reduct == reduct_oracle("SCE", x2, d2)


def test_engine_step_matches_run_prefix():
    """make_engine_step applied k times from a fresh state reproduces the
    run's selections and Θ history."""
    n, a = 120, 6
    x, d = _pinned_table(41, n, a)
    r = t_plar(x, d, delta="SCE", engine="device", grc_init=False, compute_core=False,
               device=CPU)
    step = engine.make_engine_step("SCE", "incremental", "segment", a, n, 2, 3, 1e-6, 1e-5,
                                   False, a, 64)
    valid = torch.ones(n, dtype=torch.bool)
    st = engine.init_state(n, a, valid)
    xs, ds = torch.from_numpy(x), torch.from_numpy(d)
    ws = torch.ones(n, dtype=torch.int32)
    no_core = np.zeros(a, np.int32)
    for _ in range(r.iterations):
        st = step(st, xs, ds, ws, n, r.theta_full, no_core, 0)
    nsel = int(st.n_selected)
    assert [int(v) for v in st.order[:nsel]] == r.reduct
    assert [float(t) for t in st.theta_history[:nsel]] == r.theta_history
    # one more step after the stop is a no-op (the body is gated)
    after = step(st, xs, ds, ws, n, r.theta_full, no_core, 0)
    assert all(torch.equal(u, v) for u, v in zip(after.tensors(), st.tensors()))


@pytest.mark.parametrize("delta", DELTAS)
@pytest.mark.parametrize("eng", ["host", "device"])
def test_warm_start_parity(delta, eng):
    """``warm_start=prefix`` of the cold run's own reduct gives the same
    reduct and a byte-identical Θ history on both engines; the device
    engine's warm run equals JAX's."""
    x, d = _table(np.random.default_rng(37), 180, 8)
    cold = t_plar(x, d, delta=delta, engine=eng, device=CPU)
    ks = sorted({len(cold.core), (len(cold.core) + len(cold.reduct)) // 2, len(cold.reduct)})
    for k in ks:
        warm = t_plar(x, d, delta=delta, engine=eng, warm_start=cold.reduct[:k], device=CPU)
        assert warm.reduct == cold.reduct
        assert warm.theta_history == cold.theta_history
        assert warm.core == []
        assert warm.iterations == len(cold.reduct) - k
        assert warm.theta_full == cold.theta_full
    if eng == "device":
        _assert_jax(delta, warm, j_plar(x, d, delta=delta, engine="device",
                                        warm_start=cold.reduct[:ks[-1]]))


@pytest.mark.parametrize("eng", ["host", "device"])
def test_warm_start_parity_no_core(eng):
    x, d = _table(np.random.default_rng(43), 150, 7)
    cold = t_plar(x, d, delta="SCE", engine=eng, compute_core=False, device=CPU)
    for k in range(len(cold.reduct) + 1):
        warm = t_plar(x, d, delta="SCE", engine=eng, compute_core=False,
                      warm_start=cold.reduct[:k], device=CPU)
        assert warm.reduct == cold.reduct
        assert warm.theta_history == cold.theta_history


def test_warm_start_seed_resume_one_factory():
    """A warm run is a seed and a resume through the cold run's runner:
    no new factory."""
    n, a = 160, 8
    x, d = _pinned_table(47, n, a)
    kw = dict(delta="LCE", engine="device", grc_init=False, tol=4e-6, device=CPU)
    cold = t_plar(x, d, **kw)
    before = _factories()
    warm = t_plar(x, d, warm_start=cold.reduct[: len(cold.core) or None], **kw)
    assert warm.reduct == cold.reduct
    assert _factories() == before


def test_warm_start_seed_state_carries_prefix():
    """init_state_from_reduct records the prefix fold by fold (order, Θ
    history, remaining) as JAX's does; engine_resume finishes the cold run."""
    from repro.core.engine import engine_resume as j_resume
    from repro.core.engine import init_state_from_reduct as j_seed
    from repro.core.engine import make_engine_run as j_make

    n, a = 140, 6
    x, d = _pinned_table(53, n, a)
    cold = t_plar(x, d, delta="PR", engine="device", grc_init=False, compute_core=False,
                  device=CPU)
    k = max(len(cold.reduct) - 1, 1)
    args = ("PR", "incremental", "segment", a, n, 2, 3, 1e-6, 1e-5, False, a, 64)
    runner = engine.make_engine_run(*args)
    xs, ds = torch.from_numpy(x), torch.from_numpy(d)
    ws = torch.ones(n, dtype=torch.int32)
    valid = torch.ones(n, dtype=torch.bool)
    st = engine.init_state_from_reduct(runner, n, a, valid, xs, ds, ws, n, cold.reduct[:k])
    js = j_seed(j_make(*args), n, a, np.ones(n, bool), jnp.asarray(x), jnp.asarray(d),
                jnp.ones(n, jnp.int32), jnp.int32(n), cold.reduct[:k])
    assert int(st.n_selected) == k
    assert [int(v) for v in st.order[:k]] == cold.reduct[:k]
    assert [float(t) for t in st.theta_history[:k]] == cold.theta_history[:k]
    assert not st.remaining[cold.reduct[:k]].any()
    for name in ("order", "theta_history", "remaining", "r_ids", "k", "n_selected"):
        assert np.array_equal(getattr(st, name).numpy(), np.asarray(getattr(js, name))), name
    fin = engine.engine_resume(runner, st, xs, ds, ws, n, cold.theta_full)
    nsel = int(fin.n_selected)
    assert [int(v) for v in fin.order[:nsel]] == cold.reduct
    jfin = j_resume(j_make(*args), js, jnp.asarray(x), jnp.asarray(d), jnp.ones(n, jnp.int32),
                    jnp.int32(n), cold.theta_full)
    assert np.array_equal(fin.order.numpy(), np.asarray(jfin.order))


def test_warm_start_validation():
    x, d = _table(np.random.default_rng(59), 80, 5)
    with pytest.raises(ValueError, match="duplicates"):
        t_plar(x, d, warm_start=[1, 1], device=CPU)
    with pytest.raises(ValueError, match="out of range"):
        t_plar(x, d, warm_start=[0, 7], device=CPU)
    with pytest.raises(ValueError, match="out of range"):
        t_plar(x, d, warm_start=[-1], device=CPU)
    with pytest.raises(ValueError, match="integral"):
        t_plar(x, d, warm_start=[0.5], device=CPU)
    # a prefix folds unconditionally (like a forced core), so one longer
    # than max_features is legal, folds whole and adds nothing
    assert t_plar(x, d, warm_start=[0, 1, 2], max_features=2, device=CPU).reduct == [0, 1, 2]
    assert t_plar(x, d, warm_start=[0, 1], max_features=2, device=CPU).reduct == [0, 1]


def test_engine_factory_cache_key():
    """One lru entry per logical config: positional, keyword, defaulted and
    numpy-scalar calls to the engine factories key identically; the run and
    the step of one config come from its one cached runner."""
    # a config no other test uses, so the first call is a genuine miss
    args = ("SCE", "incremental", "segment", 5, 32, 2, 3, 1e-6, 2e-5, False, 5)
    before = engine._runner.cache_info().currsize
    for make in (engine.make_engine_run, engine.make_engine_step):
        f0 = make(*args)                                    # defaulted tail
        f1 = make(*args, 64, False)                         # positional tail
        f2 = make(*args, mp_chunk=64, ladder=False)         # keyword tail
        f3 = make("SCE", mode="incremental", backend="segment",
                  n_attrs=np.int32(5), cap=np.int64(32), m=np.int32(2),
                  v_max=np.int32(3), tol=np.float64(1e-6),
                  tie_tol=np.float64(2e-5), shrink=np.bool_(False),
                  max_sel=np.int32(5))                      # numpy scalars
        assert f0 is f1 is f2 is f3
        assert engine._runner.cache_info().currsize == before + 1


# ---------------------------------------------------------------------------
# the port's own invariants
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("delta", DELTAS)
@pytest.mark.parametrize("shrink", [False, True])
@pytest.mark.parametrize("mode,ladder", [("incremental", False), ("incremental", True),
                                         ("spark", False)])
def test_device_equals_host_bitwise(delta, shrink, mode, ladder):
    """Port device engine == port host loop, bit for bit on Θ histories.
    With the ladder on, the host loop evaluates at K-adaptive rungs and the
    device engine at the top rung: the picks and histories agree."""
    x, d = _table(np.random.default_rng(61), 220, 9, vmax=4, m=3)
    backend = "sweep_xla" if ladder else "segment"
    kw = dict(delta=delta, shrink=shrink, mode=mode, ladder=ladder, backend=backend,
              device=CPU)
    _assert_same(t_plar(x, d, engine="host", **kw), t_plar(x, d, engine="device", **kw))


@pytest.mark.parametrize("period", [1, 2, 9])
def test_result_independent_of_poll_period(monkeypatch, period):
    """P ∈ {1, 2, A}: the bodies replayed past the stop are exact no-ops, so
    the result is the same bits; the bodies replayed stay within the
    documented P .. 2P − 1 past the live ones (or the A cap)."""
    x, d = _table(np.random.default_rng(67), 220, 9, vmax=4, m=3)
    base = t_plar(x, d, delta="CCE", shrink=True, engine="host", device=CPU)
    monkeypatch.setattr(engine, "POLL_PERIOD", period)
    obs.enable()
    try:
        r = t_plar(x, d, delta="CCE", shrink=True, engine="device", device=CPU)
        span = next(rec for rec in reversed(obs.get_tracer().records())
                    if rec.name == "engine.dispatch")
    finally:
        obs.disable()
    _assert_same(base, r)
    live, bodies, polls = len(r.reduct), span.args["bodies"], span.args["polls"]
    assert min(live + period, 9) <= bodies <= min(live + 2 * period - 1, 9)
    assert polls == -(-bodies // period)


# ---------------------------------------------------------------------------
# the backend table and the seams the benchmark's tools patch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,derived,expected", [
    ("DEVICE_BACKENDS", engine.DEVICE_BACKENDS, ("segment", "onehot", "fused_xla", "sweep_xla")),
    ("KERNEL_BACKENDS", engine.KERNEL_BACKENDS,
     {"pallas": "contingency", "fused": "fused", "sweep": "sweep"}),
    ("ENSEMBLE_BACKENDS", engine.ENSEMBLE_BACKENDS, ("segment", "onehot", "sweep_xla")),
    ("SWEEP_BACKENDS", plan.SWEEP_BACKENDS, ("sweep", "sweep_xla")),
    ("_THETA_BACKENDS", plan._THETA_BACKENDS,
     ("segment", "onehot", "pallas", "fused", "fused_xla", "sweep", "sweep_xla")),
    ("reduction._BACKENDS", reduction._BACKENDS,
     ("segment", "onehot", "pallas", "fused", "fused_xla", "sweep", "sweep_xla")),
], ids=lambda v: v if isinstance(v, str) else "")
def test_backend_table_yields_the_tuples(name, derived, expected):
    """Every backend tuple of the core is read from the one table and is
    the tuple the drivers, tests and the JAX parameter list know."""
    assert derived == expected
    assert type(derived) is type(expected)
    assert set(derived) <= set(plan.BACKENDS)


def test_host_loop_sweep_goes_through_ops_sweep_theta(monkeypatch):
    """The host loop's sweep evaluation looks the kernel up in
    ``kernels.contingency.ops`` at call time (the seam a score-fault tool
    patches), and a patched wrapper sees every chunk."""
    from repro_torch.kernels.contingency import ops

    x, d = _table(np.random.default_rng(71), 200, 8)
    base = t_plar(x, d, delta="SCE", backend="sweep", engine="host", device=CPU)
    inner, calls = ops.sweep_theta, []

    def sweep_theta(x_t, r_ids, d_, w, n, **kw):
        calls.append(x_t.shape[0])
        return inner(x_t, r_ids, d_, w, n, **kw)
    monkeypatch.setattr(ops, "sweep_theta", sweep_theta)
    r = t_plar(x, d, delta="SCE", backend="sweep", engine="host", device=CPU)
    assert (r.reduct, r.theta_history) == (base.reduct, base.theta_history)
    assert sum(calls) == r.n_evaluations - len(x[0])     # every candidate past the core
