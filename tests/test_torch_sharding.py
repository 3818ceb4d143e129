"""The port's logical sharding against the JAX package's, without ranks.

``_filter_spec``, ``resolve_spec``, ``_divisible`` and ``shard_by_shape``
of both packages read only a mesh's ``axis_names`` and ``shape``, so one
stand-in object serves both on every layout (JAX's ``shard_by_shape`` wraps
its spec in a ``NamedSharding``, which wants real devices: the test swaps
that wrapper for the bare spec).  The port's ``param_specs`` (keyed like its
``state_dict``, mapped through ``models.convert.specs_to_jax``) and
``cache_specs`` equal JAX's for every config, and the spec → DTensor
placements inversion puts each mesh axis on the dim that names it.
"""
import dataclasses

import pytest
from torch.distributed.tensor import Replicate, Shard

import repro.distributed.api as japi
from repro.configs import ARCH_IDS
from repro.configs import get_config as j_get_config
from repro.distributed.api import use_mesh as j_use_mesh
from repro.models import build_model as j_build_model
from repro_torch.configs import get_config
from repro_torch.distributed import api
from repro_torch.distributed.api import P, placements, use_mesh
from repro_torch.models import build_model
from repro_torch.models.convert import specs_to_jax

LAYOUTS = [
    ((16, 16), ("data", "model")),
    ((2, 16, 16), ("pod", "data", "model")),
    ((4, 2), ("data", "model")),
    ((2, 2, 2), ("pod", "data", "model")),
    ((1, 1), ("data", "model")),
]
SPECS = [
    (None, "model"), ("data", None), (("pod", "data"), None, "model"), ("model", "data"),
    (("pod", "data"), "model", None, None), (None, None, "model", None), ("pod",),
    (("data", "model"),), (None,), ("data", "model", None),
]
# (shape, spec): dims that divide and dims that don't (40 heads on 16, batch 3 on 2)
SHAPED = [
    ((40, 64), ("model", None)), ((3, 128), (("pod", "data"), None)),
    ((8, 40, 16, 64), (("pod", "data"), "model", None, None)), ((1, 6), ("data", "model")),
    ((32, 48), ("data", "model")), ((4096, 151936), ("data", "model")),
    ((2, 4, 12), (("pod", "data"), None, "model")), ((6,), (("data", "model"),)),
]


class StandIn:
    """A mesh as both packages' spec helpers read it."""

    def __init__(self, shape, names):
        self.axis_names = tuple(names)
        self.shape = dict(zip(names, shape))


@pytest.fixture
def j_bare_sharding(monkeypatch):
    monkeypatch.setattr(japi, "NamedSharding", lambda mesh, spec: spec)


@pytest.mark.parametrize("shape,names", LAYOUTS, ids=lambda v: "x".join(map(str, v)))
def test_spec_helpers_equal_jax(shape, names, j_bare_sharding):
    mesh = StandIn(shape, names)
    for spec in SPECS:
        want = tuple(japi._filter_spec(spec, mesh))
        assert tuple(api._filter_spec(spec, mesh)) == want, spec
        assert tuple(api.resolve_spec(spec, mesh)) == tuple(japi.resolve_spec(spec, mesh))
    assert api.resolve_spec(("data",)) is None and japi.resolve_spec(("data",)) is None
    for dims, spec in SHAPED:
        for entry, dim in zip(api._filter_spec(spec, mesh), dims):
            assert api._divisible(entry, dim, mesh) == japi._divisible(entry, dim, mesh)
        got = api.shard_by_shape(spec, dims, mesh)
        assert got.mesh is mesh
        assert tuple(got.spec) == tuple(japi.shard_by_shape(spec, dims, mesh)), (dims, spec)
        assert tuple(api.sharding_for(spec, mesh).spec) == tuple(japi._filter_spec(spec, mesh))


def test_non_dividing_dims_replicate():
    mesh = StandIn((2, 16, 16), ("pod", "data", "model"))
    assert tuple(api.shard_by_shape(("model", None), (40, 64), mesh).spec) == (None, None)
    assert tuple(api.shard_by_shape((("pod", "data"),), (3,), mesh).spec) == (None,)
    assert tuple(api.shard_by_shape((("pod", "data"),), (6,), mesh).spec) == ("pod",)
    assert api.fit_entry(("pod", "data"), 64, mesh) == ("pod", "data")
    assert api.axis_size("model", mesh) == 16 and api.axis_size("pipe", mesh) == 1
    assert api.mesh_batch_shards(mesh) == 32 == japi.mesh_batch_shards(mesh)
    assert tuple(api.batch_spec(None, "model")) == tuple(japi.batch_spec(None, "model"))


@pytest.mark.parametrize("shape,names", LAYOUTS, ids=lambda v: "x".join(map(str, v)))
def test_spec_to_placements_inversion(shape, names):
    """Mesh dim i is Shard(d) exactly where tensor dim d's entry names axis
    i (JAX maps dims to axes, DTensor axes to dims), else Replicate."""
    mesh = StandIn(shape, names)
    for spec in SPECS:
        resolved = api._filter_spec(spec, mesh)
        pl = placements(resolved, names)
        assert len(pl) == len(names)
        for i, axis in enumerate(names):
            dims = [d for d, e in enumerate(resolved)
                    if e == axis or (isinstance(e, tuple) and axis in e)]
            assert pl[i] == (Shard(dims[0]) if dims else Replicate()), (spec, axis)
    if "pod" in names:
        with pytest.raises(ValueError, match="mesh order"):
            placements(P(("data", "pod")), names)


def test_use_mesh_nests_and_constrain_is_a_noop_without_one():
    import torch
    mesh = StandIn((4, 2), ("data", "model"))
    x = torch.ones(4, 2)
    assert api.active_mesh() is None and api.constrain(x, "data", None) is x
    with use_mesh(mesh):
        assert api.active_mesh() is mesh
        with use_mesh(None):
            assert api.active_mesh() is None
        assert api.axis_size("data") == 4
    assert api.active_mesh() is None


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_and_cache_specs_equal_jax(arch):
    cfg = get_config(arch).reduced()
    model = build_model(cfg, device="cpu")
    for fsdp in (True, False):
        c = dataclasses.replace(cfg, fsdp=fsdp)
        model.cfg = c
        want = j_build_model(dataclasses.replace(j_get_config(arch).reduced(), fsdp=fsdp))
        got = specs_to_jax(c, model.param_specs())
        assert _plain(got) == _plain(want.param_specs()), (arch, fsdp)
    j_model = j_build_model(j_get_config(arch).reduced())
    args = (2, 16, 8) if cfg.is_encdec else (2, 16)
    for mesh in (None, StandIn((2, 4), ("data", "model")), StandIn((1, 1), ("data", "model"))):
        with use_mesh(mesh), j_use_mesh(mesh):
            assert _plain(model.cache_specs(*args)) == _plain(j_model.cache_specs(*args)), mesh


def _plain(tree):
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    return tuple(tree)
