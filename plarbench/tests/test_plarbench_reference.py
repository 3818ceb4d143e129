"""The plain reference against the program on small stand-in tables (CPU)."""
import pytest
import torch

from plarbench.reference.compare import answer_gaps, granules_off
from plarbench.reference.plar import Reducer, granulate, union_granules
from plarbench.tables import draw_rows, make_table, prototypes
from plarbench.tests._tiny import tiny_config

CPU = torch.device("cpu")


def _program(x, d, cfg, delta, **kw):
    from repro_torch.core.reduction import plar_reduce, resolve_granularity

    gran = resolve_granularity(x, d, n_dec=cfg["n_dec"], v_max=cfg["v_max"], device="cpu")
    r = plar_reduce(source=gran, delta=delta, backend="sweep", device="cpu", **kw)
    n = int(gran.num)
    return gran, n, {"reduct": r.reduct, "core": r.core, "theta_full": r.theta_full,
                     "theta_history": r.theta_history}


@pytest.mark.parametrize("delta", ["PR", "SCE", "LCE", "CCE"])
@pytest.mark.parametrize("seed", [3, 2**33 + 1])
def test_reference_equals_plar_reduce(delta, seed):
    cfg = tiny_config()
    x, d = make_table(cfg, seed, 0, CPU)
    gran, n, prog = _program(x, d, cfg, delta)
    ref_g = granulate(x, d)
    assert ref_g.n == n
    assert granules_off(gran.x[:n], gran.d[:n], gran.w[:n], ref_g) == 0
    ref = Reducer(ref_g, n_dec=cfg["n_dec"], v_max=cfg["v_max"], delta=delta).reduce()
    assert ref.reduct == prog["reduct"] and ref.core == prog["core"]
    assert answer_gaps(prog, ref)["theta_gap"] < 1e-6


def test_no_core_and_a_wide_table():
    cfg = tiny_config(attrs=150, rows=4000, v_max=3)
    x, d = make_table(cfg, 5, 0, CPU)
    _gran, _n, prog = _program(x, d, cfg, "PR", compute_core=False)
    ref = Reducer(granulate(x, d), n_dec=cfg["n_dec"], v_max=cfg["v_max"], delta="PR",
                  chunk=16).reduce(compute_core=False)
    assert prog["core"] == ref.core == []
    assert ref.reduct == prog["reduct"]


@pytest.mark.parametrize("delta", ["PR", "SCE"])
def test_warm_repair_equals_the_service(delta):
    from repro_torch.core.granularity import fold_chunk
    from repro_torch.core.reduction import resolve_granularity
    from repro_torch.service.state import repair_reduce

    cfg = tiny_config()
    protos = prototypes(cfg, 9, "stream", CPU)
    parts = [draw_rows(protos, 10000, "initial")] + [draw_rows(protos, 2500, "pool", b)
                                                      for b in range(3)]
    gran = resolve_granularity(*parts[0], n_dec=cfg["n_dec"], v_max=cfg["v_max"], device="cpu")
    union, weights = union_granules([granulate(*p) for p in parts])
    red = Reducer(union, n_dec=cfg["n_dec"], v_max=cfg["v_max"], delta=delta)
    applied = torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=torch.float64)
    red.set_weights(applied @ weights)
    prev = red.reduce().reduct
    for b in range(3):
        gran = fold_chunk(gran, *parts[1 + b], n_dec=cfg["n_dec"], v_max=cfg["v_max"],
                          device="cpu")
        applied[1 + b] += 1
        red.set_weights(applied @ weights)
        r, _kept = repair_reduce(gran, prev, delta=delta, backend="sweep")
        ref = red.repair(prev)
        assert ref.reduct == r.reduct
        assert max(abs(a - b) for a, b in zip(ref.theta_history, r.theta_history)) < 1e-6
        prev = r.reduct


def test_following_accepts_only_what_the_margin_explains():
    cfg = tiny_config()
    x, d = make_table(cfg, 4, 0, CPU)
    _gran, _n, prog = _program(x, d, cfg, "SCE")
    red = Reducer(granulate(x, d), n_dec=cfg["n_dec"], v_max=cfg["v_max"], delta="SCE",
                  margin=1e-6)
    assert red.reduce(follow=prog).off == 0
    swapped = dict(prog, reduct=prog["reduct"][:-1] + [
        next(a for a in range(cfg["attrs"]) if a not in prog["reduct"])])
    assert red.reduce(follow=swapped).off > 0


def test_reach_follows_the_program_only_within_float32():
    cfg = tiny_config()
    x, d = make_table(cfg, 6, 0, CPU)
    g = granulate(x, d)
    pr = Reducer(g, n_dec=cfg["n_dec"], v_max=cfg["v_max"], delta="PR", margin=1e-6,
                 wide_margin=2e-5)
    assert pr.reach(-0.9) == 1e-6                       # every partial sum exact
    pr.set_weights(g.w * 2**24)
    assert pr.reach(-0.9) == 2e-5                       # past 2^24 rows
    sce = Reducer(g, n_dec=cfg["n_dec"], v_max=cfg["v_max"], delta="SCE", margin=1e-6,
                  wide_margin=2e-5)
    assert sce.reach(3.0) == pytest.approx(6e-5) and sce.reach(0.5) == 2e-5


def test_following_keeps_the_reach_it_needed():
    """A followed decision is kept as the share of Θ's reach it needed; one
    past the reach is refused."""
    cfg = tiny_config()
    x, d = make_table(cfg, 8, 0, CPU)
    red = Reducer(granulate(x, d), n_dec=cfg["n_dec"], v_max=cfg["v_max"], delta="SCE",
                  margin=1e-6, wide_margin=4e-6)
    band = -1.0 + 1e-5
    assert red._within(6e-6, 2, -1.0) and red.followed["rounded"] == pytest.approx(3e-6)
    assert not red._within(1e-5, 2, -1.0) and red.followed["rounded"] == pytest.approx(3e-6)
    thetas = torch.tensor([-1.0, -1.0, band + 1e-6], dtype=torch.float64).numpy()
    assert red._pick(thetas, [0, 1, 2], follow=1) == (0, 1)    # an exact tie is no rounding
    assert red._pick(thetas, [0, 1, 2], follow=2)[1] == 1
