"""The dry-run's setups on the port (``repro_torch.launch.specs``) against
JAX's ``repro.launch.specs``.

JAX's side runs in one subprocess over 512 placeholder CPU devices
(``make_production_mesh``'s meshes); it only builds ``make_setup`` (nothing
is compiled) and the models' ``param_shapes`` / ``cache_shapes``.  The
port's side builds its setups on a fake world of the same size
(``dryrun.fake_world``: rank 0, the ``meta`` device).  Exact throughout:

* (i) ``param_shapes`` and ``cache_shapes`` equal JAX's, shape and dtype, for
  every config in ``ARCH_IDS`` at full size (the port's per-layer
  parameters stacked into JAX's layout by ``models.convert.shapes_to_jax``);
* (ii) for every runnable (arch, shape) cell on both production meshes, each
  argument's per-device shard shape and dtype (JAX's
  ``NamedSharding.shard_shape``), their byte sum (and the record's
  ``argument_bytes``, the bytes of their storages) and ``donate`` equal JAX's,
  and the AdamW moments take ``moment_dtype_for``'s dtype;
* (iii) on a fake 16 x 16 world a column-parallel [4096, 2048]·[2048, 32000]
  matmul and its redistribute count 2·256·2048·2000 operations, one
  ``all_gather`` of a 256 x 2000 payload over 16 ranks and its ring wire
  bytes, while the global-shape matmul of DTensor's sharding propagation
  is not counted;
* (viii) ``device="cuda"`` without a card still raises outside
  ``device.modelling``.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCH_IDS, get_config, runnable_cells
from repro_torch.launch import dryrun, roofline, specs
from repro_torch.launch.roofline import StepCounter, ring_wire_bytes
from repro_torch.models import build_model
from repro_torch.models.convert import shapes_to_jax

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
CACHE = (2, 16, 8)          # batch, cache length, encoder length of the cache shapes

_JAX = r"""
import json, sys
import jax
from jax.sharding import NamedSharding
from repro.configs import ARCH_IDS, get_config, runnable_cells
from repro.launch.mesh import make_production_mesh
from repro.launch.specs import make_setup, moment_dtype_for
from repro.models import build_model
b, clen, elen = (int(v) for v in sys.argv[1:4])

def flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}/{k}" if prefix else str(k)))
        return out
    return {prefix: tree}

out = {"params": {}, "caches": {}, "moments": {}, "cells": {}}
for a in ARCH_IDS:
    cfg = get_config(a)
    m = build_model(cfg)
    out["params"][a] = {k: [list(v.shape), str(v.dtype)] for k, v in flat(m.param_shapes()).items()}
    cs = m.cache_shapes(b, clen, elen) if cfg.is_encdec else m.cache_shapes(b, clen)
    out["caches"][a] = {k: [list(v.shape), str(v.dtype)] for k, v in flat(cs).items()}
    out["moments"][a] = moment_dtype_for(cfg)
for multi in (False, True):
    mesh = make_production_mesh(multi_pod=multi)
    for a, s in runnable_cells():
        fn, shapes, shardings, donate = make_setup(get_config(a), s, mesh)
        sh = flat({str(i): t for i, t in enumerate(shardings)})
        leaves = {}
        for k, v in flat({str(i): t for i, t in enumerate(shapes)}).items():
            leaves[k] = [list(sh[k].shard_shape(v.shape)), str(v.dtype)]
        out["cells"][f"{a}|{s}|{'multi' if multi else 'single'}"] = {
            "leaves": leaves, "donate": list(donate)}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_side():
    env = {**os.environ, "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=512"}
    p = subprocess.run([sys.executable, "-c", _JAX, *map(str, CACHE)], env=env,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else str(k)))
        return out
    return {prefix: tree}


def _entry(t: torch.Tensor):
    return [list(t.shape), str(t.dtype).removeprefix("torch.")]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_and_cache_shapes_equal_jax(jax_side, arch):
    cfg = get_config(arch)
    from repro_torch.device import modelling
    with modelling():
        model = build_model(cfg)
    got = {k: _entry(v) for k, v in _flat(shapes_to_jax(cfg, model.param_shapes())).items()}
    assert got == jax_side["params"][arch]
    b, clen, elen = CACHE
    cs = model.cache_shapes(b, clen, elen) if cfg.is_encdec else model.cache_shapes(b, clen)
    assert {k: _entry(v) for k, v in _flat(cs).items()} == jax_side["caches"][arch]
    assert all(t.device.type == "meta" for t in model.param_shapes().values())
    assert specs.moment_dtype_for(cfg) == jax_side["moments"][arch]


def _local(t):
    from torch.distributed.tensor import DTensor
    return t.to_local() if isinstance(t, DTensor) else t


def _port_leaves(cfg, shape_name, args):
    """The setup's arguments as JAX's flattened trees of (shard shape, dtype)."""
    kind = specs.SHAPES[shape_name].kind
    to_jax = lambda tree: shapes_to_jax(cfg, {k: _local(v) for k, v in tree.items()})  # noqa: E731
    if kind == "train":
        state, batch = args
        trees = ({**{k: to_jax(state[k]) for k in ("params", "opt_m", "opt_v")},
                  "opt_step": _local(state["opt_step"])}, batch)
    elif kind == "prefill":
        trees = (to_jax(args[0]), args[1])
    else:
        trees = (to_jax(args[0]), *args[1:])
    flat = _flat({str(i): t for i, t in enumerate(trees)})
    return {k: _entry(_local(v)) for k, v in flat.items()}


def _bytes(leaves):
    return sum(int(np.prod(s)) * torch.empty((), dtype=getattr(torch, d)).element_size()
               for s, d in leaves.values())


@pytest.mark.parametrize("mesh_kind", ["single", "multi"])
def test_setups_equal_jax_on_the_production_meshes(jax_side, mesh_kind):
    layout = dryrun._build_mesh(mesh_kind)
    with dryrun.fake_world(tuple(layout.shape.values()), layout.axis_names) as mesh:
        for arch, shape_name in runnable_cells():
            cfg = get_config(arch)
            want = jax_side["cells"][f"{arch}|{shape_name}|{mesh_kind}"]
            fn, args, placements, donate = specs.make_setup(cfg, shape_name, mesh)
            got = _port_leaves(cfg, shape_name, args)
            assert got == want["leaves"], (arch, shape_name)
            assert _bytes(got) == _bytes(want["leaves"])
            # the record's argument_bytes: the bytes of the shards' storages
            assert sum(roofline.storages(args).values()) == _bytes(want["leaves"])
            assert list(donate) == want["donate"]
            if specs.SHAPES[shape_name].kind == "train":
                m = next(iter(args[0]["opt_m"].values()))
                assert str(m.dtype).removeprefix("torch.") == specs.moment_dtype_for(cfg)
                assert callable(fn) and len(placements) == 2


def test_column_parallel_matmul_counts_exactly():
    from torch.distributed.tensor import DTensor, Replicate, Shard

    with dryrun.fake_world((16, 16), ("data", "model")) as mesh:
        dm = mesh.device_mesh
        x = torch.empty(256, 2048, dtype=torch.bfloat16, device="meta")
        w = torch.empty(2048, 2000, dtype=torch.bfloat16, device="meta")
        xd = DTensor.from_local(x, dm, [Shard(0), Replicate()], run_check=False)
        wd = DTensor.from_local(w, dm, [Replicate(), Shard(1)], run_check=False)
        with StepCounter() as c:
            y = xd @ wd
            z = y.redistribute(dm, [Shard(0), Replicate()])
        assert tuple(y.shape) == (4096, 32000) and tuple(z.to_local().shape) == (256, 32000)
    assert c.flops == 2 * 256 * 2048 * 2000           # the local product, once
    assert c.collectives == [("all_gather", 256 * 2000 * 2, 16)]
    stats = c.collective_stats()
    assert stats["total_wire_bytes"] == ring_wire_bytes("all_gather", 256 * 2000 * 2, 16)
    assert stats["total_wire_bytes"] == 15 * 256 * 2000 * 2


def test_cuda_without_a_card_still_raises():
    from repro_torch.device import modelling, resolve_device
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="is_available"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="is_available"):
        build_model(get_config("tinyllama-1.1b").reduced())
    with modelling():
        assert resolve_device("cuda").type == "meta"
    with pytest.raises(RuntimeError, match="is_available"):
        resolve_device("cuda")
