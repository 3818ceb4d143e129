"""LM distribution of the port on gloo CPU ranks, continued: the int8
compressed all-reduce, MoE expert parallelism and the elastic restore.

One JAX subprocess with 8 host devices and a world of 4 gloo ranks run at
once, then a world of 8 gloo ranks:

* compression: ``compressed_psum_mean`` over 8 ranks against JAX's
  8-device ``shard_map`` run on the same inputs: the mean bit-equal (the
  scale is one ``pmax``, the payload an exact int32 sum, the rest the same
  f32 operations), the residual within one rounding of the input's
  magnitude (XLA fuses x − q·scale into one FMA, PyTorch rounds q·scale
  first); ``compressed_grad_mean`` with ``enabled`` on (the same) and off
  (a plain mean, within f32 sum order); JAX's own
  checks (``tests/test_distributed.py:164``): 20 rounds with error feedback
  drift < 0.01 relative, one round within 0.05.  ``quantize_int8`` and
  ``dequantize_int8`` bit-equal to JAX's, here without ranks;
* MoE on reduced qwen3-moe (f32), on ``tests/test_moe_ws.py``'s inputs: the
  expert-parallel island on mesh (2, 4) (forward) and the weight-stationary
  path on (2, 2, 2) (forward, prefill, decode) against the port's local
  path, within that test's 1e-3; the kept (token, expert) pairs of every
  routing equal the local path's exactly (no pair dropped at these sizes,
  as there);
* elastic restore (``tests/test_distributed.py:221``): a checkpoint of a
  DTensor sharded over 4 ranks restores exactly onto 8.

The ranks import nothing of JAX or ``repro``.
"""
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
TESTS = os.path.join(ROOT, "tests")
DEADLINE_S = 240
ARCH = "qwen3-moe-235b-a22b"


def _comp_inputs():
    rng = np.random.default_rng(0)
    return {"x": rng.standard_normal((8, 4096)).astype(np.float32),
            "x64": rng.standard_normal((8, 64)).astype(np.float32),
            "tree_a": rng.standard_normal((8, 64)).astype(np.float32),
            "tree_b": rng.standard_normal((8, 3, 5)).astype(np.float32),
            "err_a": (rng.standard_normal((8, 64)) * 1e-3).astype(np.float32),
            "err_b": (rng.standard_normal((8, 3, 5)) * 1e-3).astype(np.float32)}


# --- the JAX reference (subprocess, 8 host devices) --------------------------


def _jax_main(tmp: str) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as JP

    from repro.distributed import compressed_grad_mean, compressed_psum_mean
    from repro.distributed.api import make_mesh, shard_map

    mesh = make_mesh((8,), ("data",))
    inp = {k: jnp.asarray(v) for k, v in _comp_inputs().items()}
    f = jax.jit(shard_map(lambda x: compressed_psum_mean(x[0], ("data",), n_shards=8),
                          mesh=mesh, in_specs=JP("data"),
                          out_specs=(JP(), JP("data")), check_vma=False))
    mean, res = f(inp["x"])
    out = {"mean": mean, "res": res.reshape(8, -1)}
    for enabled in (True, False):
        def one(a, b, ea, eb, enabled=enabled):
            m, e = compressed_grad_mean({"a": a[0], "b": b[0]}, {"a": ea[0], "b": eb[0]},
                                        ("data",), n_shards=8, enabled=enabled)
            return m["a"], m["b"], e["a"][None], e["b"][None]
        g = jax.jit(shard_map(one, mesh=mesh, in_specs=(JP("data"),) * 4,
                              out_specs=(JP(), JP(), JP("data"), JP("data")),
                              check_vma=False))
        ma, mb, ea, eb = g(inp["tree_a"], inp["tree_b"], inp["err_a"], inp["err_b"])
        out.update({f"{enabled}/ma": ma, f"{enabled}/mb": mb, f"{enabled}/ea": ea,
                    f"{enabled}/eb": eb})
    np.savez(os.path.join(tmp, "jax_comp.npz"), **{k: np.asarray(v) for k, v in out.items()})


# --- the port's worlds ----------------------------------------------------------


def _save_rank(dev, tmp: str) -> None:
    import torch

    from repro_torch.distributed import P, NamedSharding, make_mesh
    from repro_torch.train import CheckpointManager

    mesh4 = make_mesh((4,), ("data",), device="cpu")
    w = NamedSharding(mesh4, P("data")).place(torch.arange(64.0).reshape(8, 8))
    assert tuple(w.to_local().shape) == (2, 8)
    CheckpointManager(os.path.join(tmp, "ckpt")).save(1, {"w": w})


def _moe_records(record, fn):
    """Run ``fn`` with every ``moe.plan`` call recorded: (kept token ids,
    their experts) in expert-sorted order."""
    from repro_torch.models import moe

    plan = moe.plan

    def spy(x2d, router, cfg, cap, e0, e_loc):
        gates, order, slot_s, keep_s = plan(x2d, router, cfg, cap, e0, e_loc)
        flat_e = moe.route(x2d, router, cfg)[1].reshape(-1)
        kept = order[keep_s]
        record.append(((kept // cfg.top_k).tolist(), flat_e[kept].tolist(), x2d.shape[0]))
        return gates, order, slot_s, keep_s

    moe.plan = spy
    try:
        return fn()
    finally:
        moe.plan = plan


def _world8_rank(dev, tmp: str) -> None:
    import torch

    from repro_torch.configs import get_config
    from repro_torch.distributed import (P, NamedSharding, compressed_grad_mean,
                                         compressed_psum_mean, make_mesh, unshard, use_mesh)
    from repro_torch.models import build_model
    from repro_torch.train import CheckpointManager

    out = {}
    mesh8 = make_mesh((8,), ("data",), device="cpu")
    r = mesh8.rank
    inp = {k: torch.from_numpy(v) for k, v in _comp_inputs().items()}
    with use_mesh(mesh8):
        mean, res = compressed_psum_mean(inp["x"][r], ("data",), n_shards=8)
        out["mean"], out["res"] = mean.numpy(), res.numpy()
        for enabled in (True, False):
            m, e = compressed_grad_mean({"a": inp["tree_a"][r], "b": inp["tree_b"][r]},
                                        {"a": inp["err_a"][r], "b": inp["err_b"][r]},
                                        ("data",), n_shards=8, enabled=enabled)
            out.update({f"{enabled}/ma": m["a"].numpy(), f"{enabled}/mb": m["b"].numpy(),
                        f"{enabled}/ea": e["a"].numpy(), f"{enabled}/eb": e["b"].numpy()})
        # JAX's own error-feedback checks
        xs = inp["x64"]
        exact = xs.mean(0).double()
        err = torch.zeros(64)
        acc_c = torch.zeros(64, dtype=torch.float64)
        for _ in range(20):
            m, err = compressed_psum_mean(xs[r] + err, ("data",), n_shards=8)
            acc_c += m.double()
        out["drift"] = float((acc_c - 20 * exact).abs().max() / (20 * exact).abs().max())
        m, _ = compressed_psum_mean(xs[r], ("data",), n_shards=8)
        out["single"] = float((m.double() - exact).abs().max())

    # elastic restore: the 4-rank checkpoint onto 8 ranks
    _, tree, _ = CheckpointManager(os.path.join(tmp, "ckpt")).restore(
        1, shardings={"w": NamedSharding(mesh8, P("data"))})
    w = tree["w"]
    out["w_local"] = w.to_local().numpy()
    out["w_full"] = unshard(w).numpy()
    out["w_mesh"] = np.asarray(w.device_mesh.shape)

    # MoE: expert parallel on (2, 4), weight-stationary on (2, 2, 2)
    cfg = get_config(ARCH).reduced()
    ref = build_model(cfg, device="cpu")
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 16)))
    rec_ref, rec = [], []
    with torch.no_grad():
        want = _moe_records(rec_ref, lambda: ref({"tokens": toks}))
        ep = make_mesh((2, 4), ("data", "model"), device="cpu")
        model = build_model(cfg, device="cpu").shard(ep)
        with use_mesh(ep):
            got = _moe_records(rec, lambda: model({"tokens": toks}))
        out["ep_err"] = float((unshard(got) - want).abs().max())
        out["ep_routes"] = json.dumps({"data_index": ep.data_index, "calls": rec,
                                       "ref": rec_ref})

        ws_cfg = dataclasses.replace(cfg, moe_weight_stationary=True)
        pod = make_mesh((2, 2, 2), ("pod", "data", "model"), device="cpu")
        ws = build_model(ws_cfg, device="cpu").shard(pod)
        toks = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 8)))
        rec_ref, rec = [], []
        want = _moe_records(rec_ref, lambda: ref({"tokens": toks}))
        with use_mesh(pod):
            got = _moe_records(rec, lambda: ws({"tokens": toks}))
        out["ws_err"] = float((unshard(got) - want).abs().max())
        out["ws_routes"] = json.dumps({"calls": rec, "ref": rec_ref})
        toks = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 10)))
        lg, cache, n = ref.prefill({"tokens": toks[:, :8]}, cache_len=12)
        d_ref, _, _ = ref.decode(cache, toks[:, 8:9], n)
        with use_mesh(pod):
            lg_ws, cache_ws, n_ws = ws.prefill({"tokens": toks[:, :8]}, cache_len=12)
            d_ws, _, _ = ws.decode(cache_ws, toks[:, 8:9], n_ws)
        out["ws_prefill_err"] = float((unshard(lg_ws) - lg).abs().max())
        out["ws_decode_err"] = float((unshard(d_ws) - d_ref).abs().max())
    out["modules"] = json.dumps(sorted(m for m in sys.modules if m == "jax"
                                       or m.startswith("jax.") or m == "repro"
                                       or m.startswith("repro.")))
    np.savez(os.path.join(tmp, f"rank{r}.npz"), **out)


def _port_main(tmp: str, stage: str) -> None:
    from repro_torch.distributed import spawn
    if stage == "save":
        spawn(_save_rank, 4, (tmp,), device="cpu", timeout_s=DEADLINE_S - 20)
    else:
        spawn(_world8_rank, 8, (tmp,), device="cpu", timeout_s=DEADLINE_S - 20)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("moe_worlds"))
    t0 = time.perf_counter()
    boot = (f"import sys; sys.path[:0] = [{TESTS!r}, {SRC!r}]; "
            "import test_torch_lm_distributed_moe as H; ")
    env = {**os.environ, "PYTHONPATH": SRC, "OMP_NUM_THREADS": "1"}
    jax_env = {**env, "XLA_FLAGS": "--xla_force_host_platform_device_count=8",
               "JAX_PLATFORMS": "cpu"}

    def start(call, e):
        return subprocess.Popen([sys.executable, "-c", boot + call], env=e, cwd=ROOT,
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    def finish(procs, names):
        logs = []
        try:
            for p in procs:
                left = max(DEADLINE_S - (time.perf_counter() - t0), 1)
                logs.append(p.communicate(timeout=left)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        for name, p, log in zip(names, procs, logs):
            assert p.returncode == 0, f"{name} failed:\n{log[-6000:]}"

    finish([start(f"H._jax_main({tmp!r})", jax_env),
            start(f"H._port_main({tmp!r}, 'save')", env)], ("jax", "save world"))
    finish([start(f"H._port_main({tmp!r}, 'restore')", env)], ("8-rank world",))
    return tmp


def _ranks(tmp):
    return [dict(np.load(os.path.join(tmp, f"rank{r}.npz"))) for r in range(8)]


def test_quantize_roundtrip_bit_equal_to_jax():
    import jax.numpy as jnp
    import torch

    from repro.distributed import dequantize_int8 as j_deq, quantize_int8 as j_q
    from repro_torch.distributed import dequantize_int8, quantize_int8

    x = np.random.default_rng(1).standard_normal(4096).astype(np.float32) * 3
    x[:4] = [0.5, -0.5, 1.5, 2.5]                          # ties round to even
    for scale in (np.float32(3 / 127), np.float32(1e-12), np.float32(0.5)):
        q = quantize_int8(torch.from_numpy(x), torch.tensor(scale))
        jq = np.asarray(j_q(jnp.asarray(x), jnp.asarray(scale)))
        assert q.dtype == torch.int8 and np.array_equal(q.numpy(), jq), scale
        d = dequantize_int8(q, torch.tensor(scale)).numpy()
        assert np.array_equal(d, np.asarray(j_deq(jnp.asarray(jq), jnp.asarray(scale))))


def _one_rounding(got, want, x, what):
    np.testing.assert_allclose(got, want, rtol=0, atol=float(np.spacing(np.abs(x).max())),
                               err_msg=what)


def test_compressed_psum_mean_bit_equal_to_jax(worlds):
    want = np.load(os.path.join(worlds, "jax_comp.npz"))
    x = _comp_inputs()["x"]
    for r, got in enumerate(_ranks(worlds)):
        assert np.array_equal(got["mean"], want["mean"]), r
        _one_rounding(got["res"], want["res"][r], x[r], f"residual {r}")


def test_compressed_grad_mean_equal_to_jax(worlds):
    want = np.load(os.path.join(worlds, "jax_comp.npz"))
    for r, got in enumerate(_ranks(worlds)):
        for key in ("ma", "mb"):
            assert np.array_equal(got[f"True/{key}"], want[f"True/{key}"]), (r, key)
            np.testing.assert_allclose(got[f"False/{key}"], want[f"False/{key}"],
                                       rtol=1e-6, atol=1e-7)
        inp = _comp_inputs()
        for key, x in (("ea", inp["tree_a"] + inp["err_a"]), ("eb", inp["tree_b"] + inp["err_b"])):
            _one_rounding(got[f"True/{key}"], want[f"True/{key}"][r], x[r], f"{key} {r}")
            assert np.array_equal(got[f"False/{key}"], want[f"False/{key}"][r]), (r, key)


def test_error_feedback_tracks_the_exact_mean(worlds):
    for got in _ranks(worlds):
        assert float(got["drift"]) < 0.01
        assert float(got["single"]) < 0.05


def test_checkpoint_restores_across_meshes(worlds):
    full = np.arange(64.0).reshape(8, 8)
    for r, got in enumerate(_ranks(worlds)):
        assert got["w_mesh"].tolist() == [8]
        assert np.array_equal(got["w_full"], full)
        assert np.array_equal(got["w_local"], full[r:r + 1])


def _kept(calls, shift):
    """The kept (token, expert) pairs of one model call, tokens made global."""
    return sorted((t + shift, e) for toks, exps, _ in calls for t, e in zip(toks, exps))


def test_moe_expert_parallel_equals_local(worlds):
    ranks = _ranks(worlds)
    per_layer = {}
    for r, got in enumerate(ranks):
        assert float(got["ep_err"]) < 1e-3, (r, float(got["ep_err"]))
        routes = json.loads(str(got["ep_routes"]))
        ref = routes["ref"]
        for layer, call in enumerate(routes["calls"]):
            shift = routes["data_index"] * call[2]
            per_layer.setdefault(layer, set()).update(_kept([call], shift))
    assert len(per_layer) == len(ref)
    for layer, call in enumerate(ref):
        want = _kept([call], 0)
        assert len(want) == call[2] * 2, "a pair was dropped"          # top_k = 2
        assert sorted(per_layer[layer]) == want, layer


def test_moe_weight_stationary_equals_local(worlds):
    for r, got in enumerate(_ranks(worlds)):
        for key in ("ws_err", "ws_prefill_err", "ws_decode_err"):
            assert float(got[key]) < 1e-3, (r, key, float(got[key]))
        routes = json.loads(str(got["ws_routes"]))
        # every rank routes every gathered token; it keeps its experts' pairs
        assert [c[2] for c in routes["calls"]] == [c[2] for c in routes["ref"]]


def test_moe_weight_stationary_keeps_every_pair_once(worlds):
    ranks = [json.loads(str(g["ws_routes"])) for g in _ranks(worlds)]
    ref = ranks[0]["ref"]
    for layer, call in enumerate(ref):
        want = _kept([call], 0)
        # ranks (pod, data, model): the model ranks of one data shard split the experts
        got = set()
        for r in (0, 1):
            got.update(_kept([ranks[r]["calls"][layer]], 0))
        assert sorted(got) == want, layer


def test_ranks_import_no_jax(worlds):
    for r, got in enumerate(_ranks(worlds)):
        assert json.loads(str(got["modules"])) == [], r
