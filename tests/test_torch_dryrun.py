"""PLAR's dry-run cell on the port against the JAX package's.

* ``make_production_mesh``'s axes and sizes equal JAX's, whose mesh is
  built in a subprocess over 512 placeholder CPU devices.
* The record carries JAX's keys (``repro/launch/dryrun.py``'s
  ``run_plar_cell``; its ``roofline`` and ``collectives`` those of JAX's
  ``roofline_terms`` and ``CollectiveStats.as_dict``).
* At a tiny cell on 2 x 2 gloo ranks (data x model), the modelled payload
  of each collective schedule's evaluation step and of the advance step
  equals what ``plar_mesh_collective_bytes_total`` counts on every rank,
  and the mesh's Θ equals the port's solo evaluation of the whole table
  (Θ_PR bit for bit, SCE within rtol=1e-6, atol=1e-7; ``reduce_scatter``
  sums each shard's scaled θ rows, as JAX's ``merge_candidate_cont`` does,
  so its Θ_PR is not one division and is held within that tolerance).
* ``execute=True`` on a world of one gloo rank, ``report.py``'s tables
  of the records, and the CLI's failure without a cell flag (JAX's).
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from repro.launch.roofline import CollectiveStats, roofline_terms
from repro_torch.launch import dryrun, make_production_mesh, report

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
TINY = dryrun.PlarCell(G=64, A=8, V=4, M=3, K=4, n_data=2, n_model=2)
FORMS = [("all_reduce", False), ("reduce_scatter", False), ("all_reduce", True),
         ("fused", False)]
# The keys JAX's run_plar_cell sets (repro/launch/dryrun.py:164-231).
JAX_KEYS = {"arch", "shape", "mesh", "chips", "collective", "table_dtype", "fused_pack",
            "compile_s", "memory_per_device", "flops_per_device", "bytes_per_device",
            "collectives", "roofline", "model_flops_total", "status", "advance_step"}


def test_production_mesh_equals_jax():
    code = ("import json\n"
            "from repro.launch.mesh import make_production_mesh\n"
            "out = {}\n"
            "for multi in (False, True):\n"
            "    m = make_production_mesh(multi_pod=multi)\n"
            "    out[str(multi)] = [list(m.axis_names), dict(m.shape), int(m.devices.size)]\n"
            "print(json.dumps(out))\n")
    env = {**os.environ, "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=512"}
    p = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    want = json.loads(p.stdout.strip().splitlines()[-1])
    for multi in (False, True):
        got = make_production_mesh(multi_pod=multi)
        axes, shape, size = want[str(multi)]
        assert (list(got.axis_names), got.shape, got.size) == (axes, shape, size)
        assert list(got.shape) == axes                 # the dict is in axis order
    assert make_production_mesh().n_data == 16 and make_production_mesh().n_model == 16
    assert make_production_mesh(multi_pod=True).n_data == 32


@pytest.mark.parametrize("mesh_kind,shard", [("single", [20_480, 326]),
                                             ("multi", [10_240, 326])])
@pytest.mark.parametrize("collective,fused_pack", FORMS)
def test_plar_record_carries_jax_keys(mesh_kind, shard, collective, fused_pack):
    rec = dryrun.run_plar_cell(mesh_kind, collective=collective, fused_pack=fused_pack)
    assert JAX_KEYS <= set(rec) and rec["status"] == "ok" and rec["advance_step"] == "ok"
    assert rec["shard"] == shard and rec["chips"] == {"single": 256, "multi": 512}[mesh_kind]
    assert rec["compile_s"] is None and rec["modelled"]          # no device touched
    assert set(rec["memory_per_device"]) == {"argument_bytes", "output_bytes", "temp_bytes"}
    assert set(rec["roofline"]) == set(roofline_terms(1.0, 1.0, 1.0))
    assert set(CollectiveStats({}, {}, {}).as_dict()) <= set(rec["collectives"])
    assert rec["roofline_spec"] == "NVIDIA H100 SXM"         # fixed, whatever card is visible
    assert rec["memory_model"] == dryrun.MEMORY_MODEL
    assert rec["model_flops_total"] == 5_216.0 * 327_680 * 2
    # the contingency merge dominates the payload except on the fused schedule
    payload = rec["collectives"]["total_payload_bytes"]
    assert payload == (326 * 4 * 2 if collective == "fused" else 326 * 512 * 17 * 4 + (
        326 * 4 * 2 if collective == "reduce_scatter" else 326 * 4))
    rs = rec["collectives"]["wire_bytes"].get("reduce_scatter", 0.0)
    if collective == "reduce_scatter":
        nd = 16 if mesh_kind == "single" else 32
        assert rs == (nd - 1) / nd * 326 * 512 * 17 * 4


def test_int8_table_quarters_the_table_argument():
    a = dryrun.run_plar_cell("single")["memory_per_device"]["argument_bytes"]
    b = dryrun.run_plar_cell("single", table_dtype="int8")["memory_per_device"]["argument_bytes"]
    assert a - b == 20_480 * 5_216 * 3 + 20_480 * 3


def _mesh_rank(dev, out_dir):
    """One of 4 gloo ranks, mesh (data 2, model 2): every form's evaluation
    step and the advance step; counted bytes and Θ against the solo run."""
    import torch
    import torch.distributed as dist

    from repro_torch.core.distributed import _advance_step, _eval_step
    from repro_torch.core.engine import _MeshColl
    from repro_torch.distributed import make_mesh

    mesh = make_mesh((2, 2), ("data", "model"), device=dev)
    cell = TINY
    x, r_ids, d, w, valid = dryrun.shard_operands(cell, seed=3)
    lo, hi = mesh.data_index * cell.g_loc, (mesh.data_index + 1) * cell.g_loc
    full = [torch.from_numpy(a) for a in (x, r_ids, d, w, valid)]
    mine = [t[lo:hi].contiguous() for t in full]
    n = full[3].sum().to(torch.float32)
    counter = _MeshColl.bytes_counter()
    out = {"rank": dist.get_rank(), "forms": {}}
    for delta in ("PR", "SCE"):
        solo = dryrun._solo_theta(delta, *full, n, cell)
        for collective, fused_pack in FORMS:
            ev = _eval_step(mesh, delta, cell.n_bins, cell.M, cell.V, collective,
                            backend="sweep_xla" if fused_pack else "segment")
            before = counter.value
            th = ev(list(range(cell.A)), mine[1], mine[0], mine[2], mine[3], mine[4], n)
            out["forms"][f"{delta}/{collective}/{fused_pack}"] = {
                "bytes": counter.value - before, "theta": th.tolist(), "solo": solo.tolist()}
    adv = _advance_step(mesh, "SCE", cell.n_bins, cell.M, cell.V)
    before = counter.value
    new_ids, k_new, theta = adv(mine[0][:, 2].contiguous(), mine[1], mine[2], mine[3],
                                mine[4], n)
    out["advance_bytes"] = counter.value - before
    with open(os.path.join(out_dir, f"rank{dist.get_rank()}.json"), "w") as f:
        json.dump(out, f)


def test_modelled_payloads_equal_the_counted_bytes_on_gloo(tmp_path):
    from repro_torch.distributed import spawn

    spawn(_mesh_rank, 4, (str(tmp_path),), device="cpu", timeout_s=240)
    ranks = [json.loads((tmp_path / f"rank{r}.json").read_text()) for r in range(4)]
    adv = dryrun.model_advance_collectives(TINY)["total_payload_bytes"]
    for rank in ranks:
        assert rank["advance_bytes"] == adv
        for key, got in rank["forms"].items():
            delta, collective, _ = key.split("/")
            want = dryrun.model_eval_collectives(TINY, collective)["total_payload_bytes"]
            assert got["bytes"] == want, (rank["rank"], key)
            if delta == "PR" and collective != "reduce_scatter":
                assert got["theta"] == got["solo"], key
            else:
                np.testing.assert_allclose(got["theta"], got["solo"], rtol=1e-6, atol=1e-7,
                                           err_msg=key)


def test_execute_runs_one_rank_at_the_shard_shape():
    """``execute=True`` starts a world of one gloo rank itself (on the card
    ``chip_smoke.py`` phase 17 hands it a started NCCL one): each form's
    step at the shard shape equals the solo run, and the world is gone
    afterwards."""
    import torch.distributed as dist

    shard = dryrun.PlarCell(G=32, A=4, V=4, M=3, K=4, n_data=1, n_model=1)
    for collective, fused_pack in FORMS:
        rec = dryrun.run_plar_cell("single", collective=collective, fused_pack=fused_pack,
                                   execute=True, device="cpu", cell=TINY)
        ran = rec["executed"]
        assert rec["status"] == "ok" and ran["theta_equals_solo"], rec
        assert ran["shard"] == {"granules": 32, "candidates": 4, "n_bins": 16}
        assert ran["eval_payload_bytes"] == dryrun.model_eval_collectives(
            shard, collective)["total_payload_bytes"]
        assert ran["advance_payload_bytes"] == dryrun.model_advance_collectives(
            shard)["total_payload_bytes"]
        assert rec["compile_s"] is not None and "device_ms" not in ran   # no card, no time
        assert not dist.is_initialized()


def test_report_renders_the_records(tmp_path):
    recs = dryrun.main(["--plar", "--mesh", "both", "--out", str(tmp_path)])
    assert recs["mesh"] == "multi"
    records = report.load(str(tmp_path))
    assert [r["mesh"] for r in records] == ["multi", "single"]
    table = report.dryrun_table(records)
    assert table.count("| plar-sdss | eval_iteration |") == 2 and "| — |" in table
    for mesh in ("single", "multi"):
        roof = report.roofline_table(records, mesh)
        row = [line for line in roof.splitlines() if "plar-sdss" in line]
        assert len(row) == 1 and "**collective**" in row[0] and "NVLink" in row[0]


def test_no_flag_run_fails_as_jax_does(tmp_path):
    """With no --arch, --plar or --all the CLI runs the LM cell of arch
    None, as JAX's does: an error record with its traceback, exit 1."""
    import torch.distributed as dist

    with pytest.raises(SystemExit) as e:
        dryrun.main(["--out", str(tmp_path)])
    assert e.value.code == 1
    rec = json.loads((tmp_path / "None__None__single.json").read_text())
    assert rec["status"] == "error" and "unknown arch None" in rec["traceback"]
    assert not dist.is_initialized()
