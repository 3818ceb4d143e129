"""The LM cells of the port's dry-run (``repro_torch.launch.dryrun.run_cell``)
against JAX's, on small worlds.

Three processes run at once: JAX's side (a subprocess over 4 placeholder
CPU devices, a 2 x 2 ``data x model`` mesh: ``make_setup`` of each reduced
cell, its per-device argument bytes; nothing compiled), a real world of
2 x 2 gloo ranks (a subprocess: one reduced training step of the port,
counted by ``StepCounter``), and this process (the same cells on a fake
2 x 2 world).  Exact throughout:

* (iv) ``run_cell`` on reduced tinyllama, rwkv6, qwen3-moe and seamless on
  a fake 2 x 2 world, at every shape kind: JAX's record keys (less the
  ``*_tpu_corrected`` pair and ``probe_s``), ``argument_bytes`` equal to
  JAX's, the kernels' twins counted (``MODELLED`` > 0) while ``LAUNCHES``
  stay 0, and the flash forward never taking the plain version
  (``attention_ref`` runs in the training backward only, once a layer);
* (v) the collectives counted on the fake world (kind, payload, group
  size, in order) equal those the real gloo world issues for the same
  training step;
* a reduced rwkv6 whose heads do not divide the model axis: its training
  step counts, and its gradients on the gloo world equal the unsharded
  model's (1e-4 of each leaf's largest, or twice the f32 noise floor);
* (vi) the 1- and 2-period probe counts, extrapolated by
  ``roofline.extrapolate``, equal the full-depth count (operations, bytes,
  wire bytes) of a dense reduced config;
* (vii) ``report.py`` renders LM records.
"""
import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.rwkv6 import ops as rk
from repro_torch.launch import dryrun, report, roofline, specs
from repro_torch.launch.mesh import MeshLayout
from repro_torch.models.config import SHAPES, ShapeConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
TESTS = os.path.join(ROOT, "tests")
LAYOUT = MeshLayout(("data", "model"), {"data": 2, "model": 2})
CELLS = [("tinyllama-1.1b", s) for s in ("train_4k", "prefill_32k", "decode_32k")] + [
    ("rwkv6-3b", s) for s in ("train_4k", "prefill_32k", "decode_32k", "long_500k")] + [
    ("qwen3-moe-235b-a22b", s) for s in ("train_4k", "decode_32k")] + [
    ("seamless-m4t-medium", s) for s in ("train_4k", "prefill_32k", "decode_32k")]
SMALL = ShapeConfig("small_train", 64, 4, "train")      # the gloo world's step
# the shapes of the reduced cells, cut in length and batch (the counting
# costs Python dispatch an op, and the RWKV6 plain backward loops a chunk)
CUT = {"train_4k": ShapeConfig("train_4k", 128, 4, "train"),
       "prefill_32k": ShapeConfig("prefill_32k", 256, 2, "prefill"),
       "decode_32k": ShapeConfig("decode_32k", 512, 4, "decode"),
       "long_500k": ShapeConfig("long_500k", 4096, 1, "decode")}
# JAX's run_cell keys (repro/launch/dryrun.py:59-161) the port keeps
JAX_KEYS = {"arch", "shape", "mesh", "chips", "compile_s", "memory_per_device", "scanned_cost",
            "flops_per_device", "bytes_per_device", "convert_bytes_per_device", "collectives",
            "roofline", "model_flops_total", "model_flops_per_device", "useful_flops_ratio",
            "status"}
MEMORY_KEYS = {"argument_bytes", "output_bytes", "temp_bytes", "alias_bytes", "total_hbm_bytes"}

_JAX = r"""
import json, sys
import numpy as np
from repro.configs import get_config
from repro.distributed.api import make_mesh
from repro.launch import specs
from repro.models.config import ShapeConfig
import jax
cells, cut = json.loads(sys.argv[1]), json.loads(sys.argv[2])
mesh = make_mesh((2, 2), ("data", "model"))
build = {"train": specs.make_train_setup, "prefill": specs.make_prefill_setup,
         "decode": specs.make_decode_setup}
out = {}
for a, s in cells:
    shape = ShapeConfig(*cut[s])
    fn, shapes, shardings, donate = build[shape.kind](get_config(a).reduced(), shape, mesh)
    leaves = jax.tree.leaves(shapes)
    shs = jax.tree.leaves(shardings, is_leaf=lambda x: hasattr(x, "shard_shape"))
    out[f"{a}|{s}"] = int(sum(int(np.prod(sh.shard_shape(v.shape))) * v.dtype.itemsize
                              for v, sh in zip(leaves, shs)))
print(json.dumps(out))
"""


class _FakeLayout:
    axis_names, shape = LAYOUT.axis_names, LAYOUT.shape


def _reduced(arch):
    return get_config(arch).reduced()


def _rwkv_two_heads():
    """Reduced rwkv6 with 2 heads of 32: they do not divide a 4-way model axis."""
    return dataclasses.replace(_reduced("rwkv6-3b"), d_model=64, rwkv_decay_lora=8, d_ff=128)


def _gloo_rank(dev, tmp):
    """One rank of the real world of 4: the reduced tinyllama training step
    at :data:`SMALL` on a 2 x 2 mesh, counted (rank 0 writes its
    collectives); then the gradients of a reduced rwkv6 whose 2 heads do not
    divide a (1, 4) mesh's model axis, the unsharded model's, and those of
    the unsharded model with its parameters moved by f32 rounding's size."""
    from repro_torch.distributed.api import P, make_mesh, shard_by_shape, unshard, use_mesh
    from repro_torch.models import build_model

    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    fn, args, _, _ = specs.make_setup(_reduced("tinyllama-1.1b"), SMALL, mesh)
    counts = dryrun.count_step(fn, args)
    out = counts["collectives"] | {"calls": counts["calls"]}

    cfg = _rwkv_two_heads()
    gen = torch.Generator().manual_seed(3)
    batch = {k: torch.randint(0, cfg.vocab, (2, 16), generator=gen) for k in ("tokens", "labels")}
    grads = {}
    for tag, m in (("one", None), ("noisy", None),
                   ("mesh", make_mesh((1, 4), ("data", "model"), device="cpu"))):
        model = build_model(cfg, device="cpu")
        if tag == "noisy":      # the floor: parameters moved by f32 rounding's size
            noise = torch.Generator().manual_seed(1)
            with torch.no_grad():
                for p in model.parameters():
                    p.mul_(1 + 1.2e-7 * torch.randn(p.shape, generator=noise))
        if m is not None:
            model.shard(m)
        model.requires_grad_(True)
        b = batch if m is None else {k: shard_by_shape(P(("pod", "data")), v.shape, m).place(v)
                                     for k, v in batch.items()}
        with use_mesh(m):
            loss, _ = model.loss(b)
            names, params = zip(*model.named_parameters())
            gs = torch.autograd.grad(loss, params)
        grads[tag] = {n: unshard(g) for n, g in zip(names, gs)}
    out["rwkv_grads"] = {n: [float((grads["mesh"][n] - g).abs().max()),
                             float((grads["noisy"][n] - g).abs().max()), float(g.abs().max())]
                         for n, g in grads["one"].items()}
    if mesh.rank == 0:
        with open(os.path.join(tmp, "gloo.json"), "w") as f:
            json.dump(out, f)


def _gloo_main(tmp):
    from repro_torch.distributed import spawn
    spawn(_gloo_rank, 4, (tmp,), device="cpu", timeout_s=240)


@pytest.fixture(scope="module")
def others(tmp_path_factory):
    """JAX's argument bytes and the gloo world's collectives, both run in
    subprocesses while the tests count the fake worlds here."""
    tmp = str(tmp_path_factory.mktemp("dryrun_lm"))
    env = {**os.environ, "PYTHONPATH": SRC, "OMP_NUM_THREADS": "1"}
    jax_env = {**env, "JAX_PLATFORMS": "cpu",
               "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
    boot = f"import sys; sys.path[:0] = [{TESTS!r}, {SRC!r}]; import test_torch_dryrun_lm as H; "
    cut = {k: dataclasses.astuple(v) for k, v in CUT.items()}
    procs = {"jax": subprocess.Popen([sys.executable, "-c", _JAX, json.dumps(CELLS),
                                      json.dumps(cut)],
                                     env=jax_env, stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True),
             "gloo": subprocess.Popen([sys.executable, "-c", boot + f"H._gloo_main({tmp!r})"],
                                      env=env, cwd=ROOT, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)}
    yield procs, tmp
    for p in procs.values():
        if p.poll() is None:
            p.kill()


def _result(others, name):
    procs, tmp = others
    out, err = procs[name].communicate(timeout=300)
    assert procs[name].returncode == 0, (err or out)[-3000:]
    if name == "jax":
        return json.loads(out.strip().splitlines()[-1])
    with open(os.path.join(tmp, "gloo.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("arch,shape", CELLS)
def test_run_cell_keeps_jax_keys_and_argument_bytes(others, arch, shape, monkeypatch):
    calls = {"ref": 0}
    ref = fa.attention_ref

    def counted_ref(*a, **k):
        calls["ref"] += 1
        return ref(*a, **k)

    monkeypatch.setattr(fa, "attention_ref", counted_ref)
    fa.reset_launch_counts()
    rk.reset_launch_counts()
    rec = dryrun.run_cell(arch, shape, "single", cfg=_reduced(arch), layout=LAYOUT,
                          shape=CUT[shape])
    assert rec["status"] == "ok", rec
    assert JAX_KEYS <= set(rec) and set(rec["memory_per_device"]) == MEMORY_KEYS
    assert rec["modelled"] and rec["compile_s"] is None and rec["chips"] == 4
    assert "bytes_per_device_tpu_corrected" not in rec and "roofline_tpu_corrected" not in rec
    assert set(rec["roofline"]) == {"compute_s", "memory_s", "collective_s", "dominant",
                                    "bound_s"}
    assert "total_wire_bytes_per_device" in rec["collectives"]
    m = rec["memory_per_device"]
    assert m["total_hbm_bytes"] == (m["argument_bytes"] + m["output_bytes"] + m["temp_bytes"]
                                    - m["alias_bytes"])
    kind = SHAPES[shape].kind
    if kind == "train":     # every argument but the batch and the step count is updated in place
        shapes, _ = specs._train_batch(_reduced(arch), CUT[shape], mesh=_FakeLayout())
        batch = sum(t.numel() * t.element_size() // 2 for t in shapes.values())
        assert m["alias_bytes"] == m["argument_bytes"] - batch - 4
    assert rec["flops_per_device"] > 0 and rec["bytes_per_device"] > 0
    # the kernels: twins only, never a launch; the flash forward never runs the plain version
    assert sum(fa.launch_counts().values()) == 0 and sum(rk.launch_counts().values()) == 0
    modelled = rec["kernels"]["modelled_calls"]
    uses = "rwkv6" if arch.startswith("rwkv") else "flash_attention"
    if kind != "decode" or uses == "rwkv6":
        assert modelled[uses] > 0, modelled
    # attention_ref runs in the training backward only, once a layer, in each of the
    # two runs that go through the kernel (the step as configured and the probe path)
    flash = modelled["flash_attention"]
    assert calls["ref"] == (2 * flash if kind == "train" else 0)
    assert m["argument_bytes"] == _result(others, "jax")[f"{arch}|{shape}"]


def test_fake_world_collectives_equal_the_gloo_world(others):
    """Exactly, on a fake world whose DeviceMesh is the CPU's as gloo's is
    (DTensor then takes gloo's all_gather for an all-to-all); on the card's
    (CUDA) mesh each of those is the all-to-all with the same payload."""
    from torch.distributed.device_mesh import DeviceMesh

    calls = {}
    with dryrun.fake_world((2, 2), ("data", "model")) as mesh:
        dm = mesh.device_mesh
        for kind in ("cpu", "cuda"):
            if kind == "cpu":
                mesh = dataclasses.replace(mesh, device_mesh=DeviceMesh(
                    "cpu", dm.mesh, mesh_dim_names=dm.mesh_dim_names))
            else:
                mesh = dataclasses.replace(mesh, device_mesh=dm)
            fn, args, _, _ = specs.make_setup(_reduced("tinyllama-1.1b"), SMALL, mesh)
            calls[kind] = [list(c) for c in dryrun.count_step(fn, args)["calls"]]
    real = _result(others, "gloo")
    assert calls["cpu"] == real["calls"] and len(real["calls"]) > 0
    assert any(c[0] == "all_to_all" for c in calls["cuda"])
    assert [["all_gather", *c[1:]] if c[0] == "all_to_all" else c
            for c in calls["cuda"]] == real["calls"]


def test_rwkv_heads_that_do_not_divide_the_model_axis(others):
    """The reduced rwkv6 of 2 heads on a (1, 4) mesh: its training step
    counts on the fake world, and each gradient on the gloo world equals the
    unsharded model's within 1e-4 of its largest element or twice what
    moving the parameters by f32 rounding's size (1.2e-7) moves it, as the
    sharded-training tests hold them."""
    rec = dryrun.run_cell("rwkv6-3b", "train_4k", "single", cfg=_rwkv_two_heads(),
                          layout=MeshLayout(("data", "model"), {"data": 1, "model": 4}),
                          shape=ShapeConfig("train_4k", 32, 2, "train"))
    assert rec["status"] == "ok" and rec["kernels"]["modelled_calls"]["rwkv6"] > 0
    for name, (err, floor, scale) in _result(others, "gloo")["rwkv_grads"].items():
        assert scale > 0 and err <= max(1e-4 * scale, 2 * floor), (name, err, floor, scale)


def test_probe_extrapolation_equals_the_full_depth_count():
    cfg = dataclasses.replace(_reduced("tinyllama-1.1b"), n_layers=4)
    counts = {}
    with dryrun.fake_world((2, 2), ("data", "model")) as mesh:
        for n in (1, 2):
            fn, args, _, _ = specs.make_setup(specs.probe_config(cfg, n), CUT["train_4k"], mesh)
            counts[n] = dryrun.count_step(fn, args)
        fn, args, _, _ = specs.make_setup(specs.probe_config(cfg, 4), CUT["train_4k"], mesh)
        full = dryrun.count_step(fn, args)
    assert specs.n_periods_of(cfg) == 4
    for key in ("flops", "bytes"):
        assert roofline.extrapolate(counts[1][key], counts[2][key], 4) == full[key]
    wire = roofline.extrapolate(counts[1]["collectives"]["total_wire_bytes"],
                                counts[2]["collectives"]["total_wire_bytes"], 4)
    assert wire == full["collectives"]["total_wire_bytes"]
    assert counts[2]["flops"] > counts[1]["flops"]


def test_report_renders_lm_records(tmp_path):
    recs = [dryrun.run_cell("tinyllama-1.1b", "train_4k", "single",
                            cfg=_reduced("tinyllama-1.1b"), layout=LAYOUT, shape=CUT["train_4k"]),
            dryrun.run_cell("tinyllama-1.1b", "long_500k", "single")]
    assert recs[1] == {"arch": "tinyllama-1.1b", "shape": "long_500k", "mesh": "single",
                       "status": "skipped", "reason": dryrun.SKIP_REASON}
    for i, r in enumerate(recs):
        (tmp_path / f"{i}.json").write_text(json.dumps(r))
    records = report.load(str(tmp_path))
    table = report.dryrun_table(records)
    assert "| tinyllama-1.1b | train_4k | single | ok | — |" in table
    assert "| tinyllama-1.1b | long_500k | single | skipped¹ |" in table
    roof = report.roofline_table(records, "single")
    row = [line for line in roof.splitlines() if "tinyllama" in line]
    assert len(row) == 1 and "%" in row[0] and "useful %" in roof
    assert report.dominant_hint(records[0])
