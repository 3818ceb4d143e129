"""The port's four-measure ensemble (``plar_reduce_ensemble`` on ``segment``)
against the plain reference on the CPU, and its spans.

On seeded tables of the tiny configuration (20,000 x 12), each member's
core and reduct equal the float64 reference's (``plarbench.reference.plar``)
under the member's measure, and its Θ(D|C) and Θ history lie within float32
reach of the reference's: ``4e-6·max(1, |Θ|)``, the rounded reach the
kdd99 cells state (every partial sum of thousands of float32 terms rounds
at 2^-24).  One call records one ``reduce.ensemble`` that holds one
``reduce.theta_full`` and one ``reduce.core`` a member, with ``host_reads``
the counted reads it made.
"""
import numpy as np
import pytest
import torch

from plarbench.reference.plar import Reducer, granulate
from plarbench.tables import make_table
from plarbench.tests._tiny import tiny_config
from repro_torch import obs
from repro_torch.core.reduction import plar_reduce_ensemble, resolve_granularity
from repro_torch.device import host_reads

MEASURES = ("PR", "SCE", "LCE", "CCE")
REACH = 4e-6
CPU = torch.device("cpu")


def _ensemble(seed):
    cfg = tiny_config()
    x, d = make_table(cfg, seed, 0, CPU)
    gran = resolve_granularity(x, d, n_dec=cfg["n_dec"], v_max=cfg["v_max"], device=CPU)
    rs = plar_reduce_ensemble(source=gran, configs=[{"delta": m} for m in MEASURES],
                              backend="segment", device=CPU)
    return cfg, granulate(x, d), rs


@pytest.mark.parametrize("seed", [2**33 + 11, 4_280_000_012])
def test_members_equal_the_reference(seed):
    cfg, ref_g, rs = _ensemble(seed)
    for delta, r in zip(MEASURES, rs):
        ref = Reducer(ref_g, n_dec=cfg["n_dec"], v_max=cfg["v_max"], delta=delta).reduce()
        assert (r.core, r.reduct) == (ref.core, ref.reduct), delta
        got = np.array([r.theta_full] + r.theta_history)
        want = np.array([ref.theta_full] + ref.theta_history)
        assert np.all(np.abs(got - want) <= REACH * np.maximum(1.0, np.abs(want))), delta


@pytest.fixture
def tracer():
    t = obs.get_tracer()
    was = t.enabled
    t.clear()
    t.enable()
    yield t
    t.clear()
    t.enabled = was


def _inside(inner, outer) -> bool:
    return outer.t_start <= inner.t_start and inner.t_start + inner.dur <= outer.t_start + outer.dur


def test_span_tree_of_one_ensemble(tracer):
    r0 = host_reads()
    _cfg, _ref, rs = _ensemble(2**33 + 11)
    reads = host_reads() - r0
    recs = [r for r in tracer.records() if r.ph == "X"]
    by = {n: [s for s in recs if s.name == n]
          for n in ("reduce.granulate", "reduce.ensemble", "reduce.theta_full", "reduce.core",
                    "engine.dispatch_ensemble")}
    (ens,), (theta,), (dispatch,) = (by[n] for n in ("reduce.ensemble", "reduce.theta_full",
                                                     "engine.dispatch_ensemble"))
    assert len(by["reduce.core"]) == len(MEASURES)
    assert all(_inside(s, ens) for s in [theta, dispatch] + by["reduce.core"])
    assert all(g.t_start + g.dur <= ens.t_start for g in by["reduce.granulate"])
    assert [s.args["delta"] for s in by["reduce.core"]] == list(MEASURES)
    assert [s.args["core"] for s in by["reduce.core"]] == [len(r.core) for r in rs]
    assert all(s.args["host_reads"] == 1 for s in by["reduce.core"])
    assert (ens.args["configs"], ens.args["deltas"], ens.args["backend"]) == (
        len(MEASURES), ",".join(MEASURES), "segment")
    assert ens.args["bodies"] == dispatch.args["bodies"] >= max(len(r.reduct) for r in rs)
    granulate_reads = sum(s.args["host_reads"] for s in by["reduce.granulate"])
    assert ens.args["host_reads"] == reads - granulate_reads > len(MEASURES)
