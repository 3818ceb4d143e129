"""End-to-end parity: repro_torch's plar_reduce (CPU) vs repro's.

The same seeded tables go through both packages.  Reducts, cores and
iteration counts must be equal and the Θ_PR history bit-equal (integer
counts, one division); SCE/LCE/CCE histories agree within rtol=1e-6,
atol=1e-7 (XLA and PyTorch sum a contingency's rows in different orders).
The JAX side runs its host loop, with the Pallas kernels in interpret mode
for ``sweep``/``fused``/``pallas``; the port runs its default engine
(``auto``: the device engine for ``segment``/``onehot``/``fused_xla``/
``sweep_xla``, the host loop for the kernel backends), which its own tests
hold byte-identical to its host loop (``test_torch_engine.py``).  The CLI
tests hold the port's CLI against JAX's default device engine and, for
``--ensemble all --bags 2``, against JAX's CLI.

Also here: shrink, spark mode / HAR / FSPA, ``max_features``,
``warm_start``, the ladder, a granularity carried across from JAX, the CLI
with ``--device cpu``, and a subprocess check that the port imports nothing
of JAX or ``repro``.

The core step (``_core_inner_thetas``) alone, on granularities with
redundant columns, padding slots holding codes, duplicate rows of
different decisions, 24 columns (codes too wide for int32, ranked),
A = 0, 1 and 2, and keys wide enough to need two sort keys: bit for bit
against the per-attribute sort chains it replaced
(``tests/_core_chain.py``) and against the JAX package's core (Θ_PR bit
for bit, the others within the tolerances above); its ``exact=False``
sketch path unchanged.
"""
import json
import os
import subprocess
import sys
from functools import lru_cache

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _core_chain import core_by_subset_chains

from repro.core import fspa_reduce as j_fspa
from repro.core import har_reduce as j_har
from repro.core import plar_reduce as j_plar
from repro.core.granularity import Granularity as JGranularity
from repro.core.granularity import build_granularity as j_build
from repro.core.plan import theta_for_ids as j_theta_for_ids
from repro.core.reduction import _core_inner_thetas as j_core
from repro.data import scaled_paper_dataset
from repro_torch.core import fspa_reduce as t_fspa
from repro_torch.core import granularity_from_numpy
from repro_torch.core import har_reduce as t_har
from repro_torch.core import measures
from repro_torch.core import plar_reduce as t_plar
from repro_torch.core.granularity import column_terms, row_fingerprints
from repro_torch.core.plan import contingency_from_ids, ids_by_sort
from repro_torch.core.reduction import _core_inner_thetas as t_core

# The tensors here are tiny: PyTorch's intra-op thread pool only adds
# overhead, and across pytest-xdist workers it oversubscribes the cores.
torch.set_num_threads(1)

DELTAS = ["PR", "SCE", "LCE", "CCE"]
KERNEL_BACKENDS = ["segment", "sweep", "fused", "pallas"]
SIZES = {"mushroom": (400, 7), "shuttle": (1500, 9)}
CPU = "cpu"


@lru_cache(maxsize=None)
def _table(name):
    rows, attrs = SIZES[name]
    return scaled_paper_dataset(name, max_rows=rows, max_attrs=attrs).table()


@lru_cache(maxsize=None)
def _jax(name, delta, backend="segment", **kw):
    x, d = _table(name)
    return j_plar(x, d, delta=delta, backend=backend, engine="host", **kw)


def _random_table(seed, n, a, vmax=3, m=2, redundancy=0.5):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, vmax, size=(n, a)).astype(np.int32)
    for j in range(1, a):
        if rng.random() < redundancy:
            x[:, j] = x[:, rng.integers(0, j)]
    return x, rng.integers(0, m, size=n).astype(np.int32)


def _assert_parity(delta, rt, rj):
    assert rt.reduct == rj.reduct
    assert rt.core == rj.core
    assert rt.iterations == rj.iterations
    assert len(rt.theta_history) == len(rj.theta_history)
    if delta == "PR":
        assert rt.theta_history == rj.theta_history          # bit-identical floats
        assert rt.theta_full == rj.theta_full
    else:
        np.testing.assert_allclose(rt.theta_history, rj.theta_history, rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(rt.theta_full, rj.theta_full, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("delta", DELTAS)
@pytest.mark.parametrize("backend", KERNEL_BACKENDS)
def test_plar_matches_jax_same_backend(backend, delta):
    """mushroom stand-in: the port's backend vs the JAX package's same backend."""
    x, d = _table("mushroom")
    rt = t_plar(x, d, delta=delta, backend=backend, device=CPU)
    _assert_parity(delta, rt, _jax("mushroom", delta, backend))


@pytest.mark.parametrize("delta", DELTAS)
@pytest.mark.parametrize("backend", KERNEL_BACKENDS + ["onehot", "fused_xla", "sweep_xla"])
def test_plar_backends_match_jax_segment(backend, delta):
    """shuttle stand-in: every port backend vs the JAX reference engine."""
    x, d = _table("shuttle")
    rt = t_plar(x, d, delta=delta, backend=backend, device=CPU)
    _assert_parity(delta, rt, _jax("shuttle", delta))


@pytest.mark.parametrize("delta", DELTAS)
def test_shrink_matches_jax(delta):
    x, d = _table("mushroom")
    rt = t_plar(x, d, delta=delta, backend="sweep", shrink=True, device=CPU)
    _assert_parity(delta, rt, _jax("mushroom", delta, shrink=True))


@pytest.mark.parametrize("delta", DELTAS)
def test_spark_har_fspa_match_jax(delta):
    x, d = _random_table(17, 200, 8)
    _assert_parity(delta, t_plar(x, d, delta=delta, mode="spark", device=CPU),
                   j_plar(x, d, delta=delta, mode="spark", engine="host"))
    rh = t_har(x, d, delta=delta, device=CPU)
    rf = t_fspa(x, d, delta=delta, device=CPU)
    _assert_parity(delta, rh, j_har(x, d, delta=delta, engine="host"))
    _assert_parity(delta, rf, j_fspa(x, d, delta=delta, engine="host"))
    assert rh.reduct == rf.reduct                      # paper Tables 6-9


def test_max_features_and_warm_start_match_jax():
    x, d = _table("shuttle")
    kw = dict(max_features=2, compute_core=False)
    _assert_parity("SCE", t_plar(x, d, delta="SCE", backend="sweep", device=CPU, **kw),
                   _jax("shuttle", "SCE", **kw))
    cold = _jax("shuttle", "PR")
    prefix = tuple(cold.reduct[:2])
    rt = t_plar(x, d, delta="PR", backend="fused", warm_start=prefix, device=CPU)
    _assert_parity("PR", rt, _jax("shuttle", "PR", warm_start=prefix))
    assert rt.core == [] and rt.reduct == cold.reduct  # the prefix is the cold run's


@pytest.mark.parametrize("delta", ["PR", "SCE"])
def test_fingerprint_grouping_matches_jax(delta):
    """exact=False: fingerprint-pair grouping and the linear-sketch core."""
    x, d = _table("shuttle")
    rt = t_plar(x, d, delta=delta, backend="sweep", exact=False, device=CPU)
    _assert_parity(delta, rt, _jax("shuttle", delta, exact=False))


@pytest.mark.parametrize("backend", ["sweep", "sweep_xla"])
def test_ladder_matches_jax(backend):
    x, d = _table("mushroom")
    rt = t_plar(x, d, delta="LCE", backend=backend, ladder=True, device=CPU)
    _assert_parity("LCE", rt, _jax("mushroom", "LCE", "sweep_xla", ladder=True))
    # the ladder changes bins, never bits, inside the port
    off = t_plar(x, d, delta="LCE", backend=backend, device=CPU)
    assert rt.reduct == off.reduct and rt.theta_history == off.theta_history


def test_granularity_carried_from_jax():
    x, d = _table("shuttle")
    jg = j_build(x, d, n_dec=int(d.max()) + 1, v_max=int(x.max()) + 1)
    tg = granularity_from_numpy(np.asarray(jg.x), np.asarray(jg.d), np.asarray(jg.w),
                                np.asarray(jg.valid), jg.num, jg.n_total,
                                n_attrs=jg.n_attrs, n_dec=jg.n_dec, v_max=jg.v_max,
                                device=CPU)
    rt = t_plar(source=tg, delta="CCE", backend="sweep", device=CPU)
    _assert_parity("CCE", rt, j_plar(source=jg, delta="CCE", engine="host"))


def test_driver_validation():
    x, d = _random_table(3, 60, 5)
    # a kernel backend on the device engine (by name only) is the host loop's run
    dev = t_plar(x, d, engine="device", backend="sweep", device=CPU)
    host = t_plar(x, d, engine="host", backend="sweep", device=CPU)
    assert (dev.reduct, dev.theta_history) == (host.reduct, host.theta_history)
    with pytest.raises(ValueError, match="unknown engine"):
        t_plar(x, d, engine="warp", device=CPU)
    with pytest.raises(ValueError, match="unknown Θ backend"):
        t_plar(x, d, backend="nope", device=CPU)
    with pytest.raises(ValueError, match="unknown mode"):
        t_plar(x, d, mode="nope", device=CPU)
    with pytest.raises(ValueError, match="unknown selector"):
        t_plar(x, d, selector="nope", device=CPU)
    with pytest.raises(ValueError, match="duplicates"):
        t_plar(x, d, warm_start=[1, 1], device=CPU)
    with pytest.raises(ValueError, match="out of range"):
        t_plar(x, d, warm_start=[7], device=CPU)
    with pytest.raises(ValueError, match="not both"):
        t_plar(x, d, source=object(), device=CPU)
    r = t_plar(x, d, selector="pinned", engine="host", device=CPU)
    assert r.reduct == j_plar(x, d, engine="host").reduct


@pytest.mark.parametrize("grc_init", [True, False])
def test_understated_v_max_is_rejected(grc_init):
    """A caller's v_max below the table's codes is refused before any Θ is
    computed (it would pack two (class, value) pairs into one key, and the
    sweep kernel on the card would drop keys outside a class's range)."""
    x, d = _random_table(5, 80, 4, vmax=5)
    kw = dict(backend="sweep", grc_init=grc_init, device=CPU)
    with pytest.raises(ValueError, match=r"v_max=4\); the table holds codes in \[0, 4\]"):
        t_plar(x, d, v_max=4, **kw)
    assert t_plar(x, d, v_max=5, **kw).reduct == t_plar(x, d, **kw).reduct


def test_cli_device_cpu(capsys):
    from repro_torch.launch import reduce as cli

    out = cli.main(["--dataset", "mushroom", "--max-rows", "400", "--max-attrs", "10",
                    "--delta", "PR", "--backend", "sweep", "--device", "cpu", "--json"])
    printed = json.loads(capsys.readouterr().out)
    assert printed["reduct"] == out["reduct"] and out["device"] == "cpu"
    x, d = scaled_paper_dataset("mushroom", max_rows=400, max_attrs=10).table()
    rj = j_plar(x, d, delta="PR")
    assert out["reduct"] == rj.reduct and out["core"] == rj.core
    assert out["theta_history"] == rj.theta_history
    assert out["table_shape"] == [400, 10] and out["granules"] > 0
    assert out["engine"] == "host"          # auto keeps the sweep kernel on the host loop
    with pytest.raises(SystemExit):
        cli.main(["--dataset", "mushroom", "--device", "cpu", "--distributed", "--shrink"])
    assert "--shrink not supported with --distributed" in capsys.readouterr().err


def test_cli_ensemble_matches_jax_cli(capsys, monkeypatch):
    """``--ensemble all --bags 2``: the same grid, in the same order, with
    the same members as JAX's CLI prints."""
    from repro.launch import reduce as j_cli
    from repro_torch.launch import reduce as cli

    flags = ["--dataset", "mushroom", "--max-rows", "400", "--max-attrs", "10",
             "--ensemble", "all", "--bags", "2", "--json"]
    out = cli.main(flags + ["--device", "cpu"])
    capsys.readouterr()
    monkeypatch.setattr(sys, "argv", ["repro.launch.reduce"] + flags)
    j_cli.main()
    jout = json.loads(capsys.readouterr().out)
    assert out["table_shape"] == jout["table_shape"] == [400, 10]
    assert len(out["ensemble"]) == len(jout["ensemble"]) == 8
    for e, je in zip(out["ensemble"], jout["ensemble"]):
        assert (e["delta"], e["seed"]) == (je["delta"], je["seed"])
        assert (e["reduct"], e["core"], e["iterations"]) == (
            je["reduct"], je["core"], je["iterations"])
        if e["delta"] == "PR":
            assert e["theta_full"] == je["theta_full"]
        else:
            np.testing.assert_allclose(e["theta_full"], je["theta_full"], rtol=1e-6, atol=1e-7)
    with pytest.raises(SystemExit):
        cli.main(flags + ["--device", "cpu", "--backend", "sweep"])
    assert "not supported with --ensemble" in capsys.readouterr().err


# Names of a reference ``__all__`` that the port still owes, one list a
# subpackage.  Each is an expected gap: once one is ported (it appears in the
# port's module), it must also be exported, or the test below fails.  Empty
# since LM distribution (ROADMAP §1 item 8 (a)-(c)) was ported.
PENDING_EXPORTS = {}
SHARED_SUBPACKAGES = ("core", "service", "kernels.contingency", "kernels.flash_attention",
                      "kernels.rwkv6", "models", "serving", "train", "data", "obs",
                      "distributed", "launch")


def test_port_exports_every_reference_name():
    """Every subpackage both packages have: ``repro_torch.<sub>.__all__``
    lists every name of ``repro.<sub>.__all__`` but those item 8 still owes
    (``PENDING_EXPORTS``), and each listed name resolves.  A pending name
    that the port defines must be exported too."""
    import importlib

    for sub in SHARED_SUBPACKAGES:
        ref = importlib.import_module(f"repro.{sub}")
        port = importlib.import_module(f"repro_torch.{sub}")
        pending = set(PENDING_EXPORTS.get(sub, ()))
        assert pending <= set(ref.__all__), sorted(pending - set(ref.__all__))
        missing = sorted(set(ref.__all__) - set(port.__all__) - pending)
        assert not missing, f"{port.__name__} lacks {missing}"
        for name in port.__all__:
            assert hasattr(port, name), f"{port.__name__}.{name} is listed but not defined"
        ported = sorted(n for n in pending if hasattr(port, n) and n not in port.__all__)
        assert not ported, f"{port.__name__} defines {ported} without exporting them"
    import repro.launch
    import repro_torch.launch

    assert repro_torch.launch.__all__ == repro.launch.__all__


def test_port_imports_no_jax_or_repro(tmp_path):
    """Importing and running the port (reductions, the tile selector, its
    cost model and the roofline, one tiny paper table, the modelled dry-run
    cells (PLAR's, and a reduced LM training cell on a fake world) and their
    report, the bench modules (the serve bench's dedup and admission
    section), the serving example, the reduct service with
    one query served through a CPU ``ReductServer``, LM serving of every
    family (the dense, RWKV6, MoE and Mamba-hybrid engines, a VLM prefill
    with frontend features, an enc-dec prefill and decode), one reduced
    training step, one sharded training step on two spawned gloo ranks
    (the LM distribution modules imported), and the mesh driver on two
    spawned gloo ranks and, handed its partition, on one) leaves
    jax and repro out of sys.modules.  ``jax`` and ``repro`` are made
    unimportable for the process and its ranks, so a rank that imports
    either fails the run."""
    for name in ("jax", "repro"):
        (tmp_path / name).mkdir()
        (tmp_path / name / "__init__.py").write_text(
            f"raise ImportError('{name} must not be imported by the port')\n")
    code = (
        "import sys, numpy as np\n"
        "import repro_torch.distributed, repro_torch.core.distributed\n"
        "import repro_torch.core.oracle, repro_torch.launch.mesh\n"
        "import repro_torch, repro_torch.core, repro_torch.kernels.contingency\n"
        "import repro_torch.core.engine, repro_torch.launch.time_engine\n"
        "import repro_torch.kernels.contingency.autotune, repro_torch.kernels.contingency.model\n"
        "import repro_torch.launch.roofline, repro_torch.launch.time_tiles, repro_torch.cards\n"
        "from repro_torch.launch import paper_tables, dryrun, report\n"
        "rows = paper_tables.table_11(max_rows=60, max_attrs=8, device='cpu')\n"
        "assert [r['lanes'] for r in rows] == [32, 128]\n"
        "rec = dryrun.run_plar_cell('multi', collective='fused')\n"
        "assert rec['status'] == 'ok' and 'plar-sdss' in report.dryrun_table([rec])\n"
        "import repro_torch.launch.reduce, repro_torch.data, repro_torch.obs\n"
        "from repro_torch.core import plar_reduce, plar_reduce_ensemble\n"
        "rng = np.random.default_rng(0)\n"
        "x = rng.integers(0, 3, (80, 5)).astype(np.int32)\n"
        "d = rng.integers(0, 2, 80).astype(np.int32)\n"
        "for b in ('segment', 'sweep', 'fused', 'pallas'):\n"
        "    plar_reduce(x, d, delta='SCE', backend=b, device='cpu')\n"
        "plar_reduce(x, d, delta='PR', engine='device', mode='spark', device='cpu')\n"
        "plar_reduce(x, d, backend='sweep', engine='device', selector='heuristic', device='cpu')\n"
        "from repro_torch.kernels.contingency import autotune_block_sizes\n"
        "autotune_block_sizes(2, 64, 16, 2, kernel='sweep', v_max=4, refine=True, top_k=2)\n"
        "plar_reduce_ensemble(x, d, configs=['PR', 'SCE'], seeds=[0], device='cpu')\n"
        "import repro_torch.kernels.flash_attention, repro_torch.kernels.rwkv6\n"
        "import repro_torch.models.convert, repro_torch.launch.serve\n"
        "import repro_torch.launch.profile_serve, repro_torch.launch.profile_sweep\n"
        "import repro_torch.launch.time_rwkv6, repro_torch.launch.profile_train\n"
        "import repro_torch.service, repro_torch.core.recovery, repro_torch.train.checkpoint\n"
        "import repro_torch.launch.reduce_server, asyncio\n"
        "from repro_torch.service import ReductServer\n"
        "async def serve():\n"
        "    async with ReductServer(device='cpu') as srv:\n"
        "        await srv.submit('t', x[:60], d[:60], n_dec=2, v_max=3)\n"
        "        await srv.update('t', x[60:], d[60:])\n"
        "        return await srv.query('t', 'PR')\n"
        "assert asyncio.run(serve()).reduct == plar_reduce(x, d, delta='PR', device='cpu').reduct\n"
        "from repro_torch.configs import get_config\n"
        "from repro_torch.models import build_model\n"
        "from repro_torch.serving import Request, ServingEngine\n"
        "for arch in ('tinyllama-1.1b', 'rwkv6-3b'):\n"
        "    cfg = get_config(arch).reduced()\n"
        "    eng = ServingEngine(cfg, build_model(cfg, device='cpu'), max_batch=2,\n"
        "                        cache_len=24, device='cpu')\n"
        "    out = eng.serve([Request(rid=i, prompt=np.arange(3 + 7 * i), max_new_tokens=3)\n"
        "                     for i in range(3)])\n"
        "    assert [len(r.output) for r in out] == [3, 3, 3]\n"
        "import repro_torch.models.moe, repro_torch.models.ssm\n"
        "import repro_torch.models.encdec, repro_torch.models.frontends\n"
        "import torch\n"
        "for arch in ('qwen3-moe-235b-a22b', 'kimi-k2-1t-a32b', 'jamba-1.5-large-398b'):\n"
        "    cfg = get_config(arch).reduced()\n"
        "    eng = ServingEngine(cfg, build_model(cfg, device='cpu'), max_batch=2,\n"
        "                        cache_len=24, device='cpu')\n"
        "    out = eng.serve([Request(rid=i, prompt=np.arange(3 + 7 * i), max_new_tokens=3)\n"
        "                     for i in range(3)])\n"
        "    assert [len(r.output) for r in out] == [3, 3, 3]\n"
        "cfg = get_config('llava-next-34b').reduced()\n"
        "lm = build_model(cfg, device='cpu')\n"
        "feats = torch.zeros((1, cfg.frontend_tokens, cfg.frontend_dim))\n"
        "batch = {'tokens': torch.arange(12)[None], 'frontend_feats': feats}\n"
        "lg, cache, lens = lm.prefill(batch, 16)\n"
        "lg, cache, lens = lm.decode(cache, lg.argmax(-1), lens)\n"
        "cfg_t = get_config('tinyllama-1.1b').reduced()\n"
        "cfg = get_config('seamless-m4t-medium').reduced()\n"
        "ed = build_model(cfg, device='cpu')\n"
        "cache, lens = ed.prefill({'frames': torch.zeros((1, 9, cfg.frontend_dim))}, 4)\n"
        "lg, cache, lens = ed.decode(cache, torch.zeros((1, 1), dtype=torch.long), lens)\n"
        "assert lg.shape == (1, 1, cfg.vocab) and bool(torch.isfinite(lg).all())\n"
        "from repro_torch.launch import specs, bench_common, bench_serve, bench_chaos\n"
        "from repro_torch.launch import bench_obs, bench_ingest\n"
        "from repro_torch.launch.mesh import MeshLayout\n"
        "from repro_torch.models.config import ShapeConfig\n"
        "rec = dryrun.run_cell('tinyllama-1.1b', 'train_4k', 'single', cfg=cfg_t,\n"
        "    layout=MeshLayout(('data', 'model'), {'data': 2, 'model': 1}),\n"
        "    shape=ShapeConfig('train_4k', 16, 2, 'train'))\n"
        "assert rec['status'] == 'ok' and 'tinyllama' in report.dryrun_table([rec])\n"
        "assert len(bench_serve.serve_dedup_and_admission(device='cpu', n_rows=400)) == 2\n"
        "import runpy\n"
        "ex = runpy.run_path('examples/pt_serve_lm.py', run_name='pt_serve_lm')\n"
        "done = ex['main'](['--arch', 'tinyllama-1.1b', '--requests', '2', '--device', 'cpu',\n"
        "                   '--ckpt-dir', 'no-such-dir'])\n"
        "assert all(r.output for r in done)\n"
        "import repro_torch.train, repro_torch.launch.train\n"
        "state, hist = repro_torch.launch.train.main(['--arch', 'rwkv6-3b', '--smoke',\n"
        "    '--steps', '1', '--global-batch', '2', '--seq-len', '8', '--device', 'cpu'])\n"
        "assert int(state['opt_step']) == 1 and np.isfinite(hist[-1]['loss'])\n"
        "import repro_torch.distributed.compression, repro_torch.distributed.pipeline_parallel\n"
        "repro_torch.launch.train.main(['--arch', 'tinyllama-1.1b', '--smoke', '--steps', '1',\n"
        "    '--global-batch', '2', '--seq-len', '8', '--device', 'cpu', '--mesh', '2,1'])\n"
        "from repro_torch.launch import reduce as cli\n"
        "flags = ['--dataset', 'mushroom', '--max-rows', '300', '--max-attrs', '6',\n"
        "         '--delta', 'PR', '--device', 'cpu']\n"
        "dist_out = cli.main(flags + ['--distributed', '--mesh', '2,1', '--collective', 'fused'])\n"
        "assert dist_out['reduct'] == cli.main(flags)['reduct']\n"
        "import tempfile, torch.distributed as tdist\n"
        "from repro_torch.distributed import init_process_group, make_mesh\n"
        "from repro_torch.core.distributed import plar_reduce_distributed\n"
        "init_process_group('cpu', rank=0, world_size=1,\n"
        "                   store_path=tempfile.mkdtemp(dir=sys.argv[1]) + '/store')\n"
        "mesh = make_mesh((1, 1), ('data', 'model'), device='cpu')\n"
        "part = plar_reduce_distributed(torch.from_numpy(x), torch.from_numpy(d), mesh,\n"
        "                               partition=True, delta='SCE', engine='host')\n"
        "assert part.reduct == plar_reduce_distributed(x, d, mesh, delta='SCE',\n"
        "                                              engine='host').reduct\n"
        "tdist.destroy_process_group()\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'repro' or m.startswith('repro.'))\n"
        "print('BAD', bad)\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ)
    src = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
    env["PYTHONPATH"] = os.pathsep.join([str(tmp_path), src])
    env["OMP_NUM_THREADS"] = "1"
    env["REPRO_TORCH_AUTOTUNE_CACHE"] = str(tmp_path / "autotune.json")
    root = os.path.dirname(src)
    p = subprocess.run([sys.executable, "-c", code, str(tmp_path)], env=env, capture_output=True,
                       text=True, timeout=120, cwd=root)
    assert p.returncode == 0, p.stdout + p.stderr
    assert "BAD []" in p.stdout


def test_tensor_inputs_and_cpu_results_are_plain_floats():
    x, d = _random_table(5, 120, 6)
    r = t_plar(torch.from_numpy(x), torch.from_numpy(d), delta="PR", device=CPU)
    assert all(isinstance(v, float) for v in r.theta_history)
    rn = t_plar(x, d, delta="PR", device=CPU)         # numpy inputs: same answer
    assert (r.reduct, r.core, r.theta_history) == (rn.reduct, rn.core, rn.theta_history)


def _core_granularity(case):
    """numpy ``(x, d, w, valid, v_max, n_dec)`` of one granularity for the core tests."""
    rng = np.random.default_rng(CORE_CASES.index(case) + 31)
    if case == "grc_redundant":            # GrC granules of a table with copied columns
        x, d = _random_table(11, 400, 9, vmax=4, m=3, redundancy=0.6)
        g = j_build(x, d, n_dec=3, v_max=4)   # capacity 400 > the live count
        return (np.asarray(g.x), np.asarray(g.d), np.asarray(g.w), np.asarray(g.valid), 4, 3)
    if case == "padding_with_codes":       # dead slots interleaved, holding codes
        cap, a, v = 256, 6, 3
        x, d = _random_table(12, cap, a, vmax=v, m=2)
        valid = rng.random(cap) < 0.45
        w = np.where(valid, rng.integers(1, 6, cap), 0).astype(np.int32)
        return x, d, w, valid, v, 2
    if case == "duplicate_rows":           # each row thrice, with its own decisions
        x = np.repeat(rng.integers(0, 3, (60, 5)).astype(np.int32), 3, axis=0)
        d = rng.integers(0, 3, len(x)).astype(np.int32)
        return x, d, np.ones(len(x), np.int32), np.ones(len(x), bool), 3, 3
    if case == "many_columns":             # 24 columns at v_max 3: codes past 2³¹ are ranked
        x = np.where(rng.random((500, 24)) < 0.8, 0, rng.integers(1, 3, (500, 24)))
        d = rng.integers(0, 3, len(x))
        g = j_build(x.astype(np.int32), d.astype(np.int32), n_dec=3, v_max=3)
        return (np.asarray(g.x), np.asarray(g.d), np.asarray(g.w), np.asarray(g.valid), 3, 3)
    narrow = ("no_attrs", "one_attr", "two_attrs")
    if case in narrow:
        x, d = _random_table(13, 90, narrow.index(case), vmax=3, m=2)
        return x, d, np.ones(len(x), np.int32), np.ones(len(x), bool), 3, 2
    # wide_keys: cap · v_max = 2³², so every rank of a partition and a column,
    # and of two partitions, takes two keys
    cap, live, v = 65536, 300, 65536
    x = np.zeros((cap, 4), np.int32)
    x[:live] = rng.choice(np.array([0, 1, v - 1], np.int32), size=(live, 4))
    x[:live, 3] = x[:live, 0]
    d = np.zeros((cap,), np.int32)
    d[:live] = rng.integers(0, 2, live)
    valid = np.arange(cap) < live
    return x, d, valid.astype(np.int32), valid, v, 2


CORE_CASES = ("grc_redundant", "padding_with_codes", "duplicate_rows", "many_columns",
              "no_attrs", "one_attr", "two_attrs", "wide_keys")


@lru_cache(maxsize=None)
def _core_grans(case):
    """The same granularity for the port (CPU) and the JAX package."""
    x, d, w, valid, v, m = _core_granularity(case)
    num, n_total = int(valid.sum()), int(w[valid].sum())
    tg = granularity_from_numpy(x, d, w, valid, num, n_total, n_attrs=x.shape[1],
                                n_dec=m, v_max=v, device=CPU)
    jg = JGranularity(x=jnp.asarray(x), d=jnp.asarray(d), w=jnp.asarray(w),
                      valid=jnp.asarray(valid), num=jnp.int32(num),
                      n_total=jnp.int32(n_total), n_attrs=x.shape[1], n_dec=m, v_max=v)
    return tg, jg


def _assert_thetas(delta, got, want):
    if delta == "PR":
        assert np.array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("case", CORE_CASES)
@pytest.mark.parametrize("delta", DELTAS)
def test_core_from_prefix_and_suffix_partitions(delta, case):
    """The exact core equals the per-attribute sort chains bit for bit, and
    the JAX package's core (whose lexsort takes no empty key list: at A = 1
    its reference is Θ of the one class U/∅)."""
    tg, jg = _core_grans(case)
    got = t_core(tg, delta, exact=True)
    assert got.dtype == np.float64 and got.shape == (tg.n_attrs,)
    assert np.array_equal(got, core_by_subset_chains(tg, delta))
    if tg.n_attrs == 1:
        want = [float(j_theta_for_ids(delta, jnp.zeros((jg.capacity,), jnp.int32), jg,
                                      n_bins=jg.capacity))]
    else:
        want = j_core(jg, delta, exact=True)
    _assert_thetas(delta, got, want)


def _core_by_sketch(gran, delta):
    """``_core_inner_thetas(exact=False)`` as it stood: h(C\\{a}) = h(C) - term_a."""
    A, mask = gran.n_attrs, 0xFFFFFFFF
    h1, h2 = row_fingerprints(gran.x, 0), row_fingerprints(gran.x, 7919)
    out = np.zeros((A,), np.float64)
    for a in range(A):
        t1 = column_terms(gran.x[:, a], a, A, 0)
        t2 = column_terms(gran.x[:, a], a, A, 7919)
        ids, _ = ids_by_sort([(h2 - t2) & mask, (h1 - t1) & mask], gran.valid)
        cont = contingency_from_ids(ids, gran.d, gran.w, gran.valid,
                                    n_bins=gran.capacity, m=gran.n_dec)
        out[a] = float(measures.evaluate(delta, cont, gran.n_total))
    return out


@pytest.mark.parametrize("delta", DELTAS)
def test_core_sketch_path_unchanged(delta):
    tg, jg = _core_grans("padding_with_codes")
    got = t_core(tg, delta, exact=False)
    assert np.array_equal(got, _core_by_sketch(tg, delta))
    _assert_thetas(delta, got, j_core(jg, delta, exact=False))
