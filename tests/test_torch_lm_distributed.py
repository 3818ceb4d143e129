"""LM distribution of the port on gloo CPU ranks against the JAX package:
the sharded Trainer and the GPipe pipeline.

One JAX subprocess (``XLA_FLAGS=--xla_force_host_platform_device_count=8``,
as ``tests/test_distributed.py``) and one world of 4 gloo ranks
(``repro_torch.distributed.spawn``) run at once, from the same seeded
inputs:

* ``Trainer(mesh=(2, 2))`` on reduced tinyllama and rwkv6 (f32, fsdp on):
  2 steps against the one-process port Trainer (in every rank) and JAX's
  unsharded Trainer, from the same parameters (drawn with numpy per JAX
  leaf, as ``test_torch_train.py``).  Step 1's loss and grad norm within
  1e-5 relative of both, and every gradient leaf within 1e-4·max|g| of
  both.  After step 1 the trajectories part by AdamW's floor: m̂/(√v̂ + ε)
  divides gradients that cancel to ~1e-7 by a √v̂ near ε, so one rounding
  of the sum order moves such an element's step by percents of the
  learning rate (``test_torch_train.py:238``).  So step 2's loss and grad
  norm, and each parameter leaf after 2 steps (against the one-process
  port's; ``test_torch_train.py`` holds those to JAX's), are held within
  the larger of 1e-5 relative (1e-4·max|p| a leaf) and twice that floor:
  how far the one-process run moves when its starting parameters are
  scaled by 1 + N(0, 1)·1.2e-7 (about one f32 rounding);
* ``pipeline_apply`` and the gradient of ``pipeline_loss`` on 4 ``pipe``
  ranks within 1e-5 of the sequential stack and of JAX's (its 4-device
  ``shard_map`` run), output and gradient (``tests/test_moe_ws.py:47``).

The ranks import nothing of JAX or ``repro``.  Also ``launch/train.py
--mesh 2,2 --device cpu`` (its own 4 ranks).  The module imports nothing of
JAX at the top: the gloo ranks import it for their target function.
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
ARCHS = ["tinyllama-1.1b", "rwkv6-3b"]
STEPS = 2
TC = dict(peak_lr=1e-3, warmup_steps=1, total_steps=10, log_every=1)
PIPE = dict(S=4, M=8, mb=2, D=16)


def _batch(vocab, step):
    from repro_torch.data import TokenStream
    return TokenStream(vocab=vocab, seq_len=16, global_batch=4, seed=0).batch(step)


def _pipe_inputs():
    rng = np.random.default_rng(3)
    S, M, mb, D = PIPE["S"], PIPE["M"], PIPE["mb"], PIPE["D"]
    ws = (rng.standard_normal((S, D, D)) * 0.3).astype(np.float32)
    x = rng.standard_normal((M, mb, D)).astype(np.float32)
    return ws, x


def _save(path, tree):
    flat = {}

    def walk(t, prefix):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}/")
            else:
                flat[f"{prefix}{k}"] = np.asarray(v)
    walk(tree, "")
    np.savez(path, **flat)


def _load(path):
    tree = {}
    with np.load(path) as z:
        for key in z.files:
            node = tree
            *parts, last = key.split("/")
            for p in parts:
                node = node.setdefault(p, {})
            node[last] = z[key]
    return tree


def _map_tree(fn, tree):
    return {k: _map_tree(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


# --- the JAX reference (subprocess, 8 host devices) --------------------------


def _jax_main(tmp: str) -> None:
    import jax
    import jax.numpy as jnp

    from repro.distributed import pipeline_apply, pipeline_loss
    from repro.distributed.api import make_mesh
    from repro.models import build_model
    from repro.configs import get_config
    from repro.train import AdamW, TrainConfig, Trainer

    for arch in ARCHS:
        init = _load(os.path.join(tmp, f"init_{arch}.npz"))
        cfg = get_config(arch).reduced()
        tr = Trainer(cfg, TrainConfig(**TC))
        assert isinstance(tr.optimizer, AdamW)
        state = jax.tree.map(jnp.asarray, init)
        model = build_model(cfg)
        b0 = {k: jnp.asarray(v) for k, v in _batch(cfg.vocab, 0).items()}
        grads = jax.grad(lambda p: model.loss(p, b0)[0])(state["params"])
        out = {"grads": grads}
        for step in range(STEPS):
            state, m = tr.step_fn(state, {k: jnp.asarray(v)
                                          for k, v in _batch(cfg.vocab, step).items()})
            out[f"loss{step}"] = np.asarray(m["loss"])
            out[f"gnorm{step}"] = np.asarray(m["grad_norm"])
        out["params"] = state["params"]
        _save(os.path.join(tmp, f"jax_{arch}.npz"), jax.tree.map(np.asarray, out))

    mesh = make_mesh((4,), ("pipe",), devices=np.array(jax.devices()[:4]))
    ws, x = _pipe_inputs()
    stage = lambda w, h: jnp.tanh(h @ w)                                   # noqa: E731
    y = pipeline_apply(stage, mesh)(jnp.asarray(ws), jnp.asarray(x))
    loss = pipeline_loss(stage, lambda ys, lab: jnp.mean((ys - lab) ** 2), mesh)
    g = jax.grad(loss)(jnp.asarray(ws), jnp.asarray(x), jnp.ones_like(jnp.asarray(x)))
    np.savez(os.path.join(tmp, "jax_pipe.npz"), y=np.asarray(y), g=np.asarray(g))


# --- the port's world (4 gloo ranks) ------------------------------------------


def _port_rank(dev, tmp: str) -> None:
    import torch

    from repro_torch.configs import get_config
    from repro_torch.distributed import (P, make_mesh, pipeline_apply, pipeline_loss,
                                         shard_by_shape, unshard, use_mesh)
    from repro_torch.train import TrainConfig, Trainer

    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    rank0 = mesh.rank == 0
    for arch in ARCHS:
        cfg = dataclasses.replace(get_config(arch).reduced(), fsdp=True)
        init = _load(os.path.join(tmp, f"init_{arch}.npz"))
        out = {}
        rng = np.random.default_rng(5)
        noisy = dict(init, params=_map_tree(
            lambda v: (v * (1 + 1.2e-7 * rng.standard_normal(v.shape))).astype(v.dtype),
            init["params"]))
        for tag, m, tree in (("mesh", mesh, init), ("one", None, init), ("noisy", None, noisy)):
            tr = Trainer(cfg, TrainConfig(**TC), mesh=m, device="cpu")
            state = tr.state_from_tree(tree)
            b0 = {k: torch.from_numpy(v) for k, v in _batch(cfg.vocab, 0).items()}
            if m is not None:
                b0 = {k: shard_by_shape(P(("pod", "data")), v.shape, m).place(v)
                      for k, v in b0.items()}
            tr.model.requires_grad_(True)
            with use_mesh(m):
                loss, _ = tr.model.loss(b0)
                names, params = zip(*tr.model.named_parameters())
                grads = torch.autograd.grad(loss, params)
            out[f"{tag}/grads"] = {n: unshard(g).detach().numpy() for n, g in zip(names, grads)}
            for step in range(STEPS):
                state, met = tr.step_fn(state, _batch(cfg.vocab, step))
                out[f"{tag}/loss{step}"] = float(met["loss"])
                out[f"{tag}/gnorm{step}"] = float(met["grad_norm"])
            out[f"{tag}/params"] = {k: unshard(v).detach().numpy()
                                    for k, v in state["params"].items()}
        if rank0:
            _save(os.path.join(tmp, f"port_{arch}.npz"), out)

    pipe = make_mesh((4,), ("pipe",), device="cpu")
    ws, x = (torch.from_numpy(a) for a in _pipe_inputs())
    stage = lambda w, h: torch.tanh(h @ w)                                 # noqa: E731
    y = pipeline_apply(stage, pipe)(ws, x)
    w_req = ws.clone().requires_grad_(True)
    loss = pipeline_loss(stage, lambda ys, lab: torch.mean((ys - lab) ** 2), pipe)
    g, = torch.autograd.grad(loss(w_req, x, torch.ones_like(x)), [w_req])
    w_seq = ws.clone().requires_grad_(True)
    h = x
    for s in range(PIPE["S"]):
        h = torch.tanh(h @ w_seq[s])
    g_seq, = torch.autograd.grad(torch.mean((h - 1) ** 2), [w_seq])
    np.savez(os.path.join(tmp, f"port_pipe_rank{mesh.rank}.npz"), y=y.numpy(),
             g=g.numpy(), y_seq=h.detach().numpy(), g_seq=g_seq.numpy())
    with open(os.path.join(tmp, f"modules_rank{mesh.rank}.json"), "w") as f:
        json.dump(sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
                         or m == "repro" or m.startswith("repro.")), f)


def _port_main(tmp: str) -> None:
    from repro_torch.distributed import spawn
    spawn(_port_rank, 4, (tmp,), device="cpu", timeout_s=DEADLINE_S - 20)


def _seed_inits(tmp: str) -> None:
    """JAX's initial train state of each arch, its parameters drawn with
    numpy per JAX leaf (``test_torch_train._seeded_params``)."""
    import jax

    sys.path.insert(0, TESTS)
    from test_torch_train import _seeded_params

    from repro.configs import get_config
    from repro.models import build_model
    from repro.train import TrainConfig, Trainer

    for arch in ARCHS:
        tr = Trainer(get_config(arch).reduced(), TrainConfig(**TC))
        params = _seeded_params(build_model(tr.cfg), 7)
        opt = tr.optimizer.init(params)
        state = {"params": params, "opt_m": opt.m, "opt_v": opt.v, "opt_step": opt.step}
        _save(os.path.join(tmp, f"init_{arch}.npz"), jax.tree.map(np.asarray, state))


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("lm_worlds"))
    t0 = time.perf_counter()
    _seed_inits(tmp)
    boot = f"import sys; sys.path[:0] = [{TESTS!r}, {SRC!r}]; import test_torch_lm_distributed as H; "
    env = {**os.environ, "PYTHONPATH": SRC, "OMP_NUM_THREADS": "1"}
    jax_env = {**env, "XLA_FLAGS": "--xla_force_host_platform_device_count=8",
               "JAX_PLATFORMS": "cpu"}
    procs = [subprocess.Popen([sys.executable, "-c", boot + f"H.{fn}({tmp!r})"], env=e,
                              cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for fn, e in (("_jax_main", jax_env), ("_port_main", env))]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=max(DEADLINE_S - (time.perf_counter() - t0), 1))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for name, p, log in zip(("jax", "port"), procs, logs):
        assert p.returncode == 0, f"{name} failed:\n{log[-6000:]}"
    return tmp


def _close(got, want, rel, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, (what, err, scale)


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_trainer_equals_one_process_and_jax(worlds, arch):
    from repro_torch.configs import get_config
    from repro_torch.models.convert import params_from_jax

    cfg = get_config(arch).reduced()
    port = _load(os.path.join(worlds, f"port_{arch}.npz"))
    jax_out = _load(os.path.join(worlds, f"jax_{arch}.npz"))
    mesh, one, noisy = port["mesh"], port["one"], port["noisy"]
    j_grads = {k: v.numpy() for k, v in params_from_jax(cfg, jax_out["grads"]).items()}
    for step in range(STEPS):
        for key in ("loss", "gnorm"):
            got = float(mesh[f"{key}{step}"])
            floor = 0.0 if step == 0 else 2 * abs(float(noisy[f"{key}{step}"]) -
                                                  float(one[f"{key}{step}"]))
            for want in (float(one[f"{key}{step}"]), float(jax_out[f"{key}{step}"])):
                assert abs(got - want) <= max(1e-5 * abs(want), floor), (arch, key, step, got,
                                                                         want, floor)
    assert set(mesh["grads"]) == set(j_grads)
    for name, g in mesh["grads"].items():
        assert float(np.abs(g).max()) > 0, name
        _close(g, one["grads"][name], 1e-4, f"grad {name} (one process)")
        _close(g, j_grads[name], 1e-4, f"grad {name} (JAX)")
    for name, p in mesh["params"].items():
        want = one["params"][name]
        floor = 2 * float(np.abs(noisy["params"][name] - want).max())
        _close(p, want, max(1e-4, floor / float(np.abs(want).max())), f"param {name}")


def test_pipeline_equals_sequential_and_jax(worlds):
    want = np.load(os.path.join(worlds, "jax_pipe.npz"))
    for rank in range(4):
        got = np.load(os.path.join(worlds, f"port_pipe_rank{rank}.npz"))
        for key in ("y", "g"):
            assert float(np.abs(got[key] - got[f"{key}_seq"]).max()) < 1e-5, (rank, key)
            assert float(np.abs(got[key] - want[key]).max()) < 1e-5, (rank, key)
        assert float(np.abs(got["g"]).max()) > 0


def test_ranks_import_no_jax(worlds):
    for rank in range(4):
        with open(os.path.join(worlds, f"modules_rank{rank}.json")) as f:
            assert json.load(f) == [], rank


def test_train_cli_mesh_on_cpu():
    env = {**os.environ, "PYTHONPATH": SRC, "OMP_NUM_THREADS": "1"}
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--arch",
                        "tinyllama-1.1b", "--smoke", "--mesh", "2,2", "--device", "cpu",
                        "--steps", "2", "--global-batch", "4", "--seq-len", "16"],
                       env=env, cwd=ROOT, capture_output=True, text=True, timeout=DEADLINE_S)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    lines = [l for l in r.stdout.splitlines() if l.startswith("step")]
    assert lines and "mesh {'data': 2, 'model': 2}" in lines[-1], r.stdout
    loss = float(lines[-1].split("loss")[1].split()[0])
    assert np.isfinite(loss)
