"""The port's mesh device engine (gloo, 8 CPU ranks) against the JAX
package's ``shard_map(while_loop)`` engine (8 fake XLA devices), and
against the port's own mesh host loop; the bin ladder and ``sweep_xla``.

The harness is ``test_torch_distributed.py``'s: one JAX subprocess and one
gloo world of 8 ranks, run at the same time on the cases below.  Port
against JAX: reducts and cores equal, Θ_PR bit-equal, SCE within rtol=1e-6,
atol=1e-7.  Within the port: device == host (reducts and cores; Θ_PR
bit-equal, SCE within the tolerance above, as ``tests/test_distributed.py``
holds JAX's), ladder on/off and ``sweep_xla`` byte-identical within each
driver, and every rank runs the same bodies and polls.  Mirrors
``tests/test_distributed.py:66-125``.  On the CPU the body runs eagerly;
the card captures it (``tests/test_torch_cuda.py``).
"""
import numpy as np
import pytest

from repro_torch.core.distributed import ENGINE_WORKSET_FACTOR
from test_torch_distributed import (
    MESH,
    WORLD,
    _run_worlds,
    assert_matches_jax,
    assert_replicated,
)

ENGINE_TABLE = "redundant:5:320:9:3"
LADDER_TABLE = "redundant:7:2000:12:4"
VARIANTS = [("segment", True), ("sweep_xla", False), ("sweep_xla", True)]   # (backend, ladder)
# engine="auto" on ENGINE_TABLE's x, d path at (4, 2): A_loc = ceil(9 / 2),
# cap = 4 shards · 80 rows, V = 3, m = 2; the device engine's static working
# set is NEED bytes, and each rank is given the budget listed (by rank)
NEED = ENGINE_WORKSET_FACTOR * 5 * 320 * 3 * 2 * 4
BUDGETS = {"roomy": [NEED] * WORLD, "tight": [NEED - 1] * WORLD,
           "one_tight": [NEED] * 3 + [NEED - 1] + [NEED] * (WORLD - 4)}

CASES = (
    [dict(key=f"engine/{delta}/{coll}/{engine}", kind="mesh", mesh=MESH, table=ENGINE_TABLE,
          kw=dict(delta=delta, collective=coll, engine=engine))
     for delta in ("PR", "SCE") for coll in ("all_reduce", "reduce_scatter")
     for engine in ("device", "host")]
    + [dict(key=f"engine/{delta}", kind="oracle", table=ENGINE_TABLE, kw=dict(delta=delta))
       for delta in ("PR", "SCE")]
    + [dict(key=f"ladder/base/{engine}", kind="mesh", mesh=MESH, table=LADDER_TABLE,
            kw=dict(delta="SCE", engine=engine)) for engine in ("device", "host")]
    + [dict(key=f"ladder/{coll}/{backend}/{ladder}/{engine}", kind="mesh", mesh=MESH,
            table=LADDER_TABLE, kw=dict(delta="SCE", collective=coll, backend=backend,
                                        ladder=ladder, engine=engine))
       for coll in ("all_reduce", "reduce_scatter") for backend, ladder in VARIANTS
       for engine in ("device", "host")]
    + [dict(key=f"auto/{name}", kind="mesh", mesh=MESH, table=ENGINE_TABLE, budgets=budgets,
            kw=dict(delta="PR", collective="all_reduce", engine="auto"))
       for name, budgets in BUDGETS.items()]
)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return _run_worlds(CASES, str(tmp_path_factory.mktemp("engine_worlds")))


@pytest.mark.parametrize("delta", ["PR", "SCE"])
@pytest.mark.parametrize("coll", ["all_reduce", "reduce_scatter"])
def test_device_engine_matches_host_loop_jax_and_oracle(worlds, delta, coll):
    r0 = worlds["ranks"][0]
    dev, host = r0[f"engine/{delta}/{coll}/device"], r0[f"engine/{delta}/{coll}/host"]
    assert dev["reduct"] == host["reduct"] == r0[f"engine/{delta}"]["reduct"]
    assert dev["core"] == host["core"]
    if delta == "PR":
        assert dev["theta_history"] == host["theta_history"]
    else:
        np.testing.assert_allclose(dev["theta_history"], host["theta_history"],
                                   rtol=1e-6, atol=1e-7)
    for engine in ("device", "host"):
        key = f"engine/{delta}/{coll}/{engine}"
        assert_matches_jax(delta, r0[key], worlds["jax"][key])
        assert_replicated(worlds["ranks"], key)


@pytest.mark.parametrize("coll", ["all_reduce", "reduce_scatter"])
@pytest.mark.parametrize("backend,ladder", VARIANTS)
@pytest.mark.parametrize("engine", ["device", "host"])
def test_ladder_and_sweep_xla_are_byte_identical(worlds, coll, backend, ladder, engine):
    r0 = worlds["ranks"][0]
    key = f"ladder/{coll}/{backend}/{ladder}/{engine}"
    base = r0[f"ladder/base/{engine}"]
    got = r0[key]
    assert (got["reduct"], got["core"]) == (r0["ladder/base/device"]["reduct"],
                                            r0["ladder/base/device"]["core"])
    # within each driver the advance bound is ladder/backend-independent,
    # so Θ histories are byte-identical
    assert got["theta_history"] == base["theta_history"]
    assert_matches_jax("SCE", got, worlds["jax"][key])
    assert_replicated(worlds["ranks"], key)


def test_every_rank_runs_the_same_bodies_and_polls(worlds):
    """The loop stops on replicated values only, so no rank waits in a
    collective another rank never reaches."""
    device_keys = [k for k in worlds["ranks"][0] if k.endswith("/device")]
    assert len(device_keys) == 11
    for key in device_keys:
        counts = {(r[key]["bodies"], r[key]["polls"]) for r in worlds["ranks"]}
        assert len(counts) == 1, (key, counts)
        bodies, polls = counts.pop()
        assert bodies == polls >= len(worlds["ranks"][0][key]["reduct"])


@pytest.mark.parametrize("budget", sorted(BUDGETS))
def test_auto_engine_takes_the_host_loop_past_the_device_budget(worlds, budget):
    """``engine="auto"`` runs the device engine only where its static
    working set fits the smallest budget over the ranks (one rank short is
    enough for the host loop), every rank alike; the answer is JAX's
    (whose ``auto`` always takes the device engine)."""
    key = f"auto/{budget}"
    want = "device" if budget == "roomy" else "host"
    for r in worlds["ranks"]:
        assert (r[key]["engine_ran"], r[key]["host_loops"]) == (want, int(want == "host"))
    assert_matches_jax("PR", worlds["ranks"][0][key], worlds["jax"][key])
    assert_replicated(worlds["ranks"], key)
