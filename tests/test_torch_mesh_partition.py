"""The mesh driver with each rank's own partition handed over
(``plar_reduce_distributed(partition=True)``) on a world of 4 gloo ranks,
mesh (4, 1), at a small kdd99-shaped table (41 attributes, 23 classes, 10
codes: ``plarbench/configs/kdd99.json`` at 20,000 rows).

* Every schedule on the host loop (the cell's loop; the device engine
  takes the same per-shard tables): the partition path equals the
  whole-table path bit for bit (reduct, core, Θ(D|C), Θ history) on every
  rank, and every rank returns the same answer.
* The partition path's reduct and core equal ``plar_reduce``'s on the
  whole table, and its granules (every rank's, summed), core and reduct
  equal the plain reference's (``plarbench/reference/plar.py``), its Θ
  history within kdd99.batch's ``theta_reach``.
* The spans ``mesh.granulate``, ``mesh.core``, ``mesh.loop`` and
  ``mesh.iteration`` and their attributes are recorded on every rank, and
  each rank's reads are counted (``plar_host_reads_total``).

One world runs every case, in a subprocess (``_main``), as
``tests/test_torch_distributed.py`` does; ``test_torch_cuda_mesh.py`` runs
the same world on 4 NCCL ranks where 4 cards are visible.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
TESTS = os.path.join(ROOT, "tests")
if ROOT not in sys.path:            # plarbench's tables and reference
    sys.path.insert(0, ROOT)
WORLD = 4
MESH = (4, 1)
ROWS = 20000
SEED = 2**33 + 17
DEADLINE_S = 240
CASES = [("all_reduce", "host"), ("reduce_scatter", "host"), ("fused", "host")]
SPAN_ATTRS = {
    "mesh.granulate": {"rows", "granules", "host_reads"},
    "mesh.core": {"gathered_bytes", "n_attrs", "core", "host_reads"},
    "mesh.loop": {"collective_bytes", "host_reads", "iterations"},
    "mesh.iteration": {"i", "candidates", "n_bins", "collective", "bytes"},
}


def config(rows: int) -> dict:
    with open(os.path.join(ROOT, "plarbench", "configs", "kdd99.json")) as f:
        cfg = json.load(f)
    return {**cfg, "rows": rows}


def _answer(r) -> dict:
    return {"reduct": list(r.reduct), "core": list(r.core), "theta_full": float(r.theta_full),
            "theta_history": [float(t) for t in r.theta_history]}


def _rank(device, out_dir: str, rows: int) -> None:
    """One rank: every case through both paths; writes ``rank{r}.json``
    and, for the partition path of the first case, this rank's granules."""
    import torch.distributed as dist

    from plarbench.tables import make_table
    from repro_torch import obs
    from repro_torch.core.distributed import partition_rows, plar_reduce_distributed
    from repro_torch.device import host_reads
    from repro_torch.distributed import make_mesh

    obs.enable()
    mesh = make_mesh(MESH, ("data", "model"), device=device)
    cfg = config(rows)
    x, d = make_table(cfg, SEED, 0, "cpu")
    lo, hi = partition_rows(x.shape[0], mesh)
    kw = dict(delta="SCE", backend="segment", compute_core=True)
    out = {"rank": dist.get_rank(), "cases": {}}
    for coll, engine in CASES:
        whole = plar_reduce_distributed(x.numpy(), d.numpy(), mesh, collective=coll,
                                        engine=engine, **kw)
        before = obs.get_tracer().recorded
        reads = host_reads()
        part = plar_reduce_distributed(x[lo:hi].to(device), d[lo:hi].to(device), mesh,
                                       partition=True, collective=coll, engine=engine, **kw)
        reads = host_reads() - reads
        fresh = obs.get_tracer().recorded - before
        spans = obs.get_tracer().records()[-fresh:]
        out["cases"][f"{coll}/{engine}"] = {
            "whole": _answer(whole), "partition": _answer(part), "reads": reads,
            "spans": {s.name: sorted(s.args or {}) for s in spans if s.name.startswith("mesh.")},
            "span_reads": sum((s.args or {}).get("host_reads", 0) for s in spans
                              if s.name in ("mesh.granulate", "mesh.core", "mesh.loop"))}
        if (coll, engine) == CASES[0]:
            g = part.granules
            np.savez(os.path.join(out_dir, f"granules{dist.get_rank()}.npz"),
                     **{k: getattr(g, k)[g.valid].cpu().numpy() for k in ("x", "d", "w")})
    with open(os.path.join(out_dir, f"rank{dist.get_rank()}.json"), "w") as f:
        json.dump(out, f)


def _main(out_dir: str, device: str, rows: int) -> None:
    from repro_torch.distributed import spawn

    spawn(_rank, WORLD, (out_dir, rows), device=device, timeout_s=DEADLINE_S - 30)


def run_world(tmp: str, device: str = "cpu", rows: int = ROWS) -> list:
    """The world's per-rank records (``_rank``), run in a subprocess."""
    boot = (f"import sys; sys.path[:0] = [{TESTS!r}, {SRC!r}, {ROOT!r}]; "
            f"import test_torch_mesh_partition as H; H._main({tmp!r}, {device!r}, {rows})")
    env = {**os.environ, "PYTHONPATH": SRC, "OMP_NUM_THREADS": "1"}
    p = subprocess.run([sys.executable, "-c", boot], env=env, cwd=ROOT, capture_output=True,
                       text=True, timeout=DEADLINE_S)
    assert p.returncode == 0, (p.stdout + p.stderr)[-6000:]
    ranks = []
    for r in range(WORLD):
        with open(os.path.join(tmp, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    return ranks


def assert_partition_equals_whole(ranks, case: str) -> None:
    for rec in ranks:
        got = rec["cases"][case]
        assert got["partition"] == got["whole"], (rec["rank"], case)     # bit for bit
        assert got["partition"] == ranks[0]["cases"][case]["partition"]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("mesh_partition"))
    return tmp, run_world(tmp)


@pytest.mark.parametrize("case", [f"{c}/{e}" for c, e in CASES])
def test_partition_equals_whole_table(world, case):
    assert_partition_equals_whole(world[1], case)


def test_partition_equals_plar_reduce_and_the_reference(world):
    from plarbench.reference.compare import answer_gaps, granules_off
    from plarbench.reference.plar import Reducer, granulate, reach
    from plarbench.tables import make_table
    from repro_torch.core import plar_reduce

    tmp, ranks = world
    got = ranks[0]["cases"]["all_reduce/host"]["partition"]
    x, d = make_table(config(ROWS), SEED, 0, "cpu")
    solo = plar_reduce(x, d, delta="SCE", backend="segment", device="cpu")
    assert got["reduct"] == list(solo.reduct) and got["core"] == list(solo.core)

    parts = [np.load(os.path.join(tmp, f"granules{r}.npz")) for r in range(WORLD)]
    prog = [np.concatenate([p[k] for p in parts]) for k in ("x", "d", "w")]
    ref_g = granulate(x, d)
    assert granules_off(*prog, ref_g) == 0
    assert sum(int(p["w"].sum()) for p in parts) == ROWS
    with open(os.path.join(ROOT, "plarbench", "workloads", "kdd99.batch.json")) as f:
        theta_reach = json.load(f)["theta_reach"]
    cfg = config(ROWS)
    ans = Reducer(ref_g, n_dec=cfg["n_dec"], v_max=cfg["v_max"], delta="SCE",
                  **reach(theta_reach)).reduce(compute_core=True, follow=got)
    gaps = answer_gaps(got, ans)
    assert gaps["reduct_off"] == 0 and gaps["core_off"] == 0
    assert gaps["theta_gap"] <= 1e-5


@pytest.mark.parametrize("case", [f"{c}/{e}" for c, e in CASES])
def test_spans_on_every_rank(world, case):
    for rec in world[1]:
        got = rec["cases"][case]
        assert set(got["spans"]) == set(SPAN_ATTRS), (rec["rank"], case)
        for name, attrs in SPAN_ATTRS.items():
            assert attrs <= set(got["spans"][name]), (rec["rank"], name)
        # the three outer spans count every read the call makes
        assert got["span_reads"] == got["reads"] > 0
