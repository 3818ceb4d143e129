"""The port's training path against the JAX package, at the reduced size.

Reduced tinyllama and rwkv6 (f32, no remat) on the CPU: the attention and
RWKV6 kernels' differentiable wrappers take their plain forwards there, and
the JAX side runs its Pallas kernels in interpret mode.  Both packages get
the same parameters (drawn with numpy per JAX leaf, carried over with
``params_from_jax``) and the same batches (``TokenStream``, equal in both).
The JAX side compiles one loss gradient per config and one train step.

Tolerances: the loss within 1e-5 relative; every gradient leaf within
1e-4·max|JAX grad| of the leaf; AdamW's params, m and v within 1e-6
relative (an m or v kept in bf16 under active clipping: one bf16 rounding,
because the clip scale comes from a global norm summed in another order);
the schedule within 1e-7.  Within the port, recompute and restart are
bit-exact and two microbatches equal one batch within f32 sum order.
"""
import dataclasses
import functools
import os
import signal
import threading
import time
import zlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as j_get_config
from repro.data import TokenStream as JTokenStream
from repro.models import build_model as j_build_model
from repro.models.layers import ParamDef as JParamDef
from repro.train import AdamW as JAdamW
from repro.train import CheckpointManager as JCheckpointManager
from repro.train import TrainConfig as JTrainConfig
from repro.train import Trainer as JTrainer
from repro.train import constant_schedule as j_constant_schedule
from repro.train import cosine_schedule as j_cosine_schedule
from repro_torch.configs import get_config
from repro_torch.data import TokenStream
from repro_torch.launch import train as train_cli
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_jax, params_to_jax
from repro_torch.train import (AdamW, CheckpointManager, TrainConfig, Trainer,
                               constant_schedule, cosine_schedule, make_train_step)

torch.set_num_threads(1)

ARCHS = ["tinyllama-1.1b", "rwkv6-3b"]
CPU = "cpu"


def _seeded_params(j_model, seed):
    """The JAX parameter tree, each leaf drawn with numpy as init_from_defs
    draws it (zeros, ones, or N(0, 1)·(fan_in⁻¹ᐟ² or 0.02))."""
    def leaf(path, d):
        name = jax.tree_util.keystr(path)
        if d.init in ("zeros", "ones"):
            a = np.zeros(d.shape) if d.init == "zeros" else np.ones(d.shape)
        else:
            rng = np.random.default_rng([seed, zlib.crc32(name.encode())])
            scale = d.shape[-2] ** -0.5 if d.init == "fan_in" and len(d.shape) >= 2 else 0.02
            a = rng.standard_normal(d.shape) * scale
        return jnp.asarray(a, jnp.dtype(d.dtype))
    return jax.tree_util.tree_map_with_path(
        leaf, j_model.param_defs(), is_leaf=lambda v: isinstance(v, JParamDef))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _port_model(cfg, j_params):
    model = build_model(cfg, device=CPU)
    model.load_state_dict(params_from_jax(cfg, _np_tree(j_params)))
    return model


def _grads(model, batch):
    """(loss, {name: grad}) of the port's loss, as the train step takes it."""
    model.requires_grad_(True)
    loss, _ = model.loss(batch)
    names, params = zip(*model.named_parameters())
    return loss.detach(), dict(zip(names, torch.autograd.grad(loss, params)))


def _close_rel(got, want, what, rel=1e-4):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= rel * scale, (what, float(np.abs(got - want).max()),
                                                            scale)


def _batch(vocab, b=2, s=24, seed=0):
    return TokenStream(vocab=vocab, seq_len=s, global_batch=b, seed=seed).batch(0)


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def _jax_step(arch):
    """JAX's loss and gradients at the seeded parameters (one compile)."""
    j_cfg = j_get_config(arch).reduced()
    j_model = j_build_model(j_cfg)
    j_params = _seeded_params(j_model, 7)
    batch = _batch(j_cfg.vocab)
    batch["loss_mask"] = (np.arange(24)[None] % 5 != 0).repeat(2, 0).astype(np.float32)
    (loss, _), grads = jax.jit(jax.value_and_grad(j_model.loss, has_aux=True))(
        j_params, {k: jnp.asarray(v) for k, v in batch.items()})
    return j_params, batch, float(loss), _np_tree(grads)


# ---------------------------------------------------------------------------
# one step against JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_gradients_match_jax(arch):
    """Loss (masked) and every gradient leaf of one step, through the
    differentiable flash / RWKV6 wrappers."""
    cfg = get_config(arch).reduced()
    j_params, batch, j_loss, j_grads = _jax_step(arch)
    loss, grads = _grads(_port_model(cfg, j_params), _torch_batch(batch))
    assert abs(float(loss) - j_loss) <= 1e-5 * abs(j_loss), (float(loss), j_loss)
    want = params_from_jax(cfg, j_grads)
    assert set(want) == set(grads)
    for name, g in grads.items():
        assert float(g.abs().max()) > 0, name
        _close_rel(g, want[name], f"grad {name}")


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("policy", ["nothing", "dots", "per_block"])
def test_remat_policies_keep_gradients(arch, policy):
    """Recompute changes memory, never values: gradients bit-equal to remat off."""
    cfg = get_config(arch).reduced()
    j_params, batch, _, _ = _jax_step(arch)
    _, want = _grads(_port_model(cfg, j_params), _torch_batch(batch))
    cfg_r = dataclasses.replace(cfg, remat=True, remat_policy=policy)
    _, got = _grads(_port_model(cfg_r, j_params), _torch_batch(batch))
    for name in want:
        assert torch.equal(got[name], want[name]), name


def test_microbatches_equal_one_batch():
    """Two microbatches (f32 gradient sums / 2) against one batch of 8."""
    cfg = get_config("tinyllama-1.1b").reduced()
    batch = TokenStream(vocab=cfg.vocab, seq_len=16, global_batch=8, seed=1).batch(0)
    seen = {}

    class Recording:          # the optimizer interface the step uses
        def __init__(self, opt, key):
            self.opt, self.key, self.lr = opt, key, opt.lr

        def update(self, grads, state, params):
            seen[self.key] = {k: g.clone() for k, g in grads.items()}
            return self.opt.update(grads, state, params)

    opt = AdamW(lr=constant_schedule(1e-3), weight_decay=0.0, grad_clip=0.0)
    metrics = {}
    for n in (1, 2):
        model = build_model(cfg, device=CPU, generator=torch.Generator().manual_seed(0))
        params = dict(model.named_parameters())
        st = opt.init(params)
        state = {"params": params, "opt_m": st.m, "opt_v": st.v, "opt_step": st.step}
        _, metrics[n] = make_train_step(model, Recording(opt, n), microbatches=n)(state, batch)
    for name, g in seen[1].items():
        _close_rel(seen[2][name], g, f"grad {name}", rel=1e-5)
    assert abs(float(metrics[2]["loss"]) - float(metrics[1]["loss"])) <= 1e-5 * float(
        metrics[1]["loss"])


# ---------------------------------------------------------------------------
# optimizer and schedule against JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clipped", [False, True])
def test_adamw_update_matches_jax(moment_dtype, clipped):
    """Six updates on the same f32 and bf16 leaves and gradients."""
    rng = np.random.default_rng(3)
    shapes = {"a": (64, 32), "b": (32,), "c": (7, 5)}
    p0 = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    j_opt = JAdamW(lr=j_cosine_schedule(1e-2, 3, 20), moment_dtype=moment_dtype)
    opt = AdamW(lr=cosine_schedule(1e-2, 3, 20), moment_dtype=moment_dtype)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    jp["c"], tp["c"] = jp["c"].astype(jnp.bfloat16), tp["c"].to(torch.bfloat16)
    js, ts = j_opt.init(jp), opt.init(tp)
    moment_tol = 2.0 ** -8 if (clipped and moment_dtype == "bfloat16") else 1e-6
    for i in range(6):
        g = {k: rng.standard_normal(s).astype(np.float32) * (10.0 if clipped else 0.01)
             for k, s in shapes.items()}
        jp, js, jn = j_opt.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        tp, ts, tn = opt.update({k: torch.from_numpy(v) for k, v in g.items()}, ts, tp)
        assert abs(float(tn) - float(jn)) <= 1e-6 * float(jn)
        for k in shapes:
            assert tp[k].dtype == {"a": torch.float32, "b": torch.float32,
                                   "c": torch.bfloat16}[k]
            _close_rel(tp[k].float(), jp[k].astype(jnp.float32), f"param {k}", rel=1e-6)
            for got, want, what in ((ts.m[k], js.m[k], "m"), (ts.v[k], js.v[k], "v")):
                assert str(got.dtype) == f"torch.{moment_dtype}"
                w = np.asarray(want.astype(jnp.float32))
                np.testing.assert_allclose(got.float().numpy(), w, rtol=moment_tol,
                                           atol=1e-6 * float(np.abs(w).max()),
                                           err_msg=f"{what} {k} step {i}")
    assert int(ts.step) == int(js.step) == 6


def test_cosine_schedule_matches_jax():
    lr, j_lr = cosine_schedule(3e-4, 10, 110), j_cosine_schedule(3e-4, 10, 110)
    for step in (0, 5, 10, 60, 110, 150):          # 0, warmup, its end, mid, end, past it
        got = float(lr(torch.tensor(step, dtype=torch.int32)))
        assert abs(got - float(j_lr(jnp.asarray(step, jnp.int32)))) <= 1e-7 * 3e-4, step
    assert float(constant_schedule(0.5)(torch.tensor(3))) == float(
        j_constant_schedule(0.5)(jnp.asarray(3)))


# ---------------------------------------------------------------------------
# checkpoints across the packages, and the port's own restart
# ---------------------------------------------------------------------------


def _small_tc(ckpt_dir, **kw):
    base = dict(peak_lr=1e-3, warmup_steps=2, total_steps=50, ckpt_every=5,
                ckpt_dir=None if ckpt_dir is None else str(ckpt_dir), log_every=5)
    base.update(kw)
    return base


def test_checkpoints_resume_across_packages(tmp_path):
    """JAX trains one step and checkpoints; the port restores it and takes
    step 2, JAX takes step 2 from its state: the same parameters and
    moments.  Then JAX restores the port's step-2 checkpoint and takes step
    3, against the port's own step 3.

    Both start from the same parameters, drawn with numpy (JAX's own init
    seeds from the process's salted ``hash``, so each process would check
    other weights).  Each leaf within 1e-5·max|JAX| of it, or twice the
    port's own f32 floor there where that is larger: how far the port's
    step moves the leaf when the state it starts from is scaled by
    1 + N(0, 1)·1.2e-7 (about one f32 rounding).  AdamW's m̂/(√v̂ + ε)
    divides a gradient that cancels to ~1e-7 by a √v̂ of ~30ε, so where a
    moment starts at zero one rounding of the gradient moves the step by
    percents.
    """
    j_cfg = j_get_config("tinyllama-1.1b").reduced()
    cfg = get_config("tinyllama-1.1b").reduced()
    j_stream = JTokenStream(vocab=j_cfg.vocab, seq_len=16, global_batch=4, seed=0)
    j_data = lambda step: {k: jnp.asarray(v) for k, v in j_stream.batch(step).items()}  # noqa: E731
    stream = TokenStream(vocab=cfg.vocab, seq_len=16, global_batch=4, seed=0)

    jt = JTrainer(j_cfg, JTrainConfig(**_small_tc(tmp_path / "jax")))
    seeded = _seeded_params(jt.model, 11)
    opt = jt.optimizer.init(seeded)
    j_state0 = {"params": seeded, "opt_m": opt.m, "opt_v": opt.v, "opt_step": opt.step}
    j_state, _ = jt.fit(j_data, steps=1, state=j_state0, start_step=0)  # checkpoint at step 1
    j_state1 = jax.tree.map(np.asarray, j_state)
    j_state2, _ = jt.step_fn(jax.tree.map(jnp.asarray, j_state1), j_data(1))

    port = Trainer(cfg, TrainConfig(**_small_tc(tmp_path / "jax")), device=CPU)
    state, _ = port.fit(stream.batch, steps=2)                      # restores 1, saves 2
    assert port.ckpt.latest_step() == 2
    assert int(state["opt_step"]) == 2

    probe = Trainer(cfg, TrainConfig(**_small_tc(None)), device=CPU)
    rng = np.random.default_rng(0)

    def floors(tree, step):
        """max|Δ| of each leaf after one port step from ``tree``, rounded
        once and not."""
        out = []
        for noisy in (False, True):
            t = dict(tree)
            if noisy:
                t["params"] = jax.tree.map(
                    lambda a: (a * (1 + 1.2e-7 * rng.standard_normal(a.shape))).astype(a.dtype),
                    tree["params"])
            st, _ = probe.step_fn(probe.state_from_tree(t), stream.batch(step))
            out.append({name: {k: v.detach().clone() for k, v in st[name].items()}
                        for name in ("params", "opt_m", "opt_v")})
        return {name: {k: float((out[1][name][k] - out[0][name][k]).abs().max())
                       for k in out[0][name]} for name in out[0]}

    def same(port_state, jax_state, floor, what):
        want = {name: params_from_jax(cfg, _np_tree(jax_state[name]))
                for name in ("params", "opt_m", "opt_v")}
        for name in want:
            for key, t in port_state[name].items():
                scale = float(np.abs(np.asarray(want[name][key], np.float32)).max())
                rel = max(1e-5, 2 * floor[name][key] / scale) if scale else 1e-5
                _close_rel(t.detach(), want[name][key], f"{what} {name} {key}", rel=rel)

    same(state, j_state2, floors(j_state1, 1), "step 2")
    _, tree, _ = JCheckpointManager(str(tmp_path / "jax")).restore(2)
    tree = jax.tree.map(np.asarray, tree)
    j_state3, _ = jt.step_fn(jax.tree.map(jnp.asarray, tree), j_data(2))
    floor3 = floors(tree, 2)
    state3, _ = port.fit(stream.batch, steps=3, state=state, start_step=2)
    same(state3, j_state3, floor3, "step 3")


def test_checkpoint_resume_bit_exact(tmp_path):
    """Stop at 4, resume to 6 == a straight run to 6 (same data), bit for bit."""
    cfg = get_config("tinyllama-1.1b").reduced()
    stream = TokenStream(vocab=cfg.vocab, seq_len=32, global_batch=4, seed=0)
    tc = TrainConfig(**_small_tc(tmp_path / "ckpt", ckpt_every=2))
    Trainer(cfg, tc, device=CPU).fit(stream.batch, steps=4)
    resumed = Trainer(cfg, tc, device=CPU)          # restores the step-4 checkpoint
    state_b, _ = resumed.fit(stream.batch, steps=6)
    straight = Trainer(cfg, dataclasses.replace(tc, ckpt_dir=str(tmp_path / "ckpt2")), device=CPU)
    state_c, _ = straight.fit(stream.batch, steps=6)
    for name in ("params", "opt_m", "opt_v"):
        for key, t in state_b[name].items():
            assert torch.equal(t, state_c[name][key]), (name, key)
    assert resumed.ckpt.all_steps() == [2, 4, 6]


def test_checkpoint_tree_is_jax_layout(tmp_path):
    """The saved keys are JAX's (stacked blocks), bf16 leaves included."""
    cfg = dataclasses.replace(get_config("rwkv6-3b").reduced(), param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    trainer = Trainer(cfg, TrainConfig(**_small_tc(tmp_path)), device=CPU)
    state = trainer.init_state()
    tree = trainer.state_to_tree(state)
    j_model = j_build_model(j_get_config("rwkv6-3b").reduced())
    j_shapes = jax.tree.map(lambda d: d.shape, j_model.param_defs(),
                            is_leaf=lambda v: isinstance(v, JParamDef))
    shapes = jax.tree.map(lambda a: a.shape, tree["params"])
    assert shapes == j_shapes
    trainer.ckpt.save(0, tree)
    _, back, _ = trainer.ckpt.restore(0)
    restored = trainer.state_from_tree(back)
    for key, t in state["params"].items():
        assert restored["params"][key].dtype == t.dtype and torch.equal(restored["params"][key], t)
    assert params_to_jax(cfg, state["opt_m"]).keys() == tree["opt_m"].keys()


# ---------------------------------------------------------------------------
# mirrors of tests/test_train.py
# ---------------------------------------------------------------------------


@pytest.fixture()
def small_setup(tmp_path):
    cfg = get_config("tinyllama-1.1b").reduced()
    tc = TrainConfig(**_small_tc(tmp_path / "ckpt"))
    stream = TokenStream(vocab=cfg.vocab, seq_len=32, global_batch=4, seed=0)
    return cfg, tc, stream.batch


def test_loss_decreases(small_setup):
    cfg, tc, data_fn = small_setup
    state, hist = Trainer(cfg, tc, device=CPU).fit(data_fn, steps=25)
    assert hist[-1]["loss"] < hist[0]["loss"]


@pytest.mark.parametrize("arch", ["rwkv6-3b"])
def test_loss_decreases_rwkv(arch, tmp_path):
    cfg = get_config(arch).reduced()
    stream = TokenStream(vocab=cfg.vocab, seq_len=32, global_batch=4, seed=0)
    tc = TrainConfig(**_small_tc(None, microbatches=2))
    _, hist = Trainer(cfg, tc, device=CPU).fit(stream.batch, steps=15)
    assert hist[-1]["loss"] < hist[0]["loss"]


def test_checkpoint_atomicity_and_retention(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = {"a": np.arange(10.0), "b": {"c": np.ones((3, 3))}}
    for step in (1, 2, 3, 4):
        mgr.save(step, tree)
    assert mgr.all_steps() == [3, 4]          # retention
    step, restored, _ = mgr.restore()
    assert step == 4
    np.testing.assert_array_equal(restored["a"], tree["a"])
    np.testing.assert_array_equal(restored["b"]["c"], tree["b"]["c"])
    os.makedirs(str(tmp_path / "step_000000099"))   # uncommitted: ignored
    assert mgr.latest_step() == 4


def test_checkpoint_async(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    tree = {"w": torch.randn(256, 256, generator=torch.Generator().manual_seed(0))}
    path = mgr.save(7, tree, blocking=False)
    mgr.wait()
    assert os.path.exists(os.path.join(path, "COMMITTED"))
    _, restored, _ = mgr.restore(7)
    np.testing.assert_array_equal(restored["w"], tree["w"].numpy())


def test_preemption_checkpoints_and_exits(small_setup):
    cfg, tc, data_fn = small_setup
    trainer = Trainer(cfg, tc, device=CPU)
    trainer.install_preemption_handler()

    def preempt():
        time.sleep(3.0)
        signal.raise_signal(signal.SIGTERM)

    threading.Thread(target=preempt, daemon=True).start()
    trainer.fit(data_fn, steps=10_000)
    assert trainer.ckpt.latest_step() is not None
    assert trainer.ckpt.latest_step() < 10_000


def test_straggler_detector(small_setup):
    cfg, tc, data_fn = small_setup
    trainer = Trainer(cfg, tc, device=CPU)
    orig = Trainer.step_fn.func(trainer)

    def spiky(state, batch):
        out = orig(state, batch)
        if int(out[0]["opt_step"]) == 7:
            time.sleep(1.5)
        return out

    trainer.__dict__["step_fn"] = spiky
    trainer.fit(data_fn, steps=12)
    # the step that ran as opt_step 7; a step beside a checkpoint's
    # background write may be flagged too on a loaded host
    assert 6 in trainer.straggler_steps, trainer.straggler_steps


def test_adamw_converges_quadratic():
    opt = AdamW(lr=constant_schedule(0.1), weight_decay=0.0, grad_clip=0.0)
    params = {"w": torch.tensor([5.0, -3.0])}
    state = opt.init(params)
    for _ in range(200):
        params, state, _ = opt.update({"w": 2 * params["w"]}, state, params)
    assert float(params["w"].abs().max()) < 1e-2


def test_cosine_schedule_shape():
    lr = cosine_schedule(1.0, warmup=10, total=110, floor=0.1)
    assert float(lr(torch.tensor(0))) == 0.0
    assert abs(float(lr(torch.tensor(10))) - 1.0) < 1e-6
    assert float(lr(torch.tensor(60))) < 1.0
    assert abs(float(lr(torch.tensor(110))) - 0.1) < 1e-6


def test_bf16_moments_track_f32():
    opt32 = AdamW(lr=constant_schedule(0.05), weight_decay=0.0, moment_dtype="float32")
    opt16 = AdamW(lr=constant_schedule(0.05), weight_decay=0.0, moment_dtype="bfloat16")
    p32, p16 = {"w": torch.full((64,), 2.0)}, {"w": torch.full((64,), 2.0)}
    s32, s16 = opt32.init(p32), opt16.init(p16)
    rng = np.random.default_rng(0)
    for _ in range(50):
        g = torch.from_numpy(rng.standard_normal(64).astype(np.float32)) * 0.1 + p32["w"] * 0.2
        p32, s32, _ = opt32.update({"w": g}, s32, p32)
        p16, s16, _ = opt16.update({"w": g}, s16, p16)
    assert s16.m["w"].dtype == torch.bfloat16
    assert float((p32["w"] - p16["w"]).abs().max()) < 0.05


def test_data_stream_deterministic_and_shardable():
    s = TokenStream(vocab=100, seq_len=8, global_batch=8, seed=3)
    np.testing.assert_array_equal(s.batch(5)["tokens"], s.batch(5)["tokens"])
    stacked = np.concatenate([s.shard(5, i, 4)["tokens"] for i in range(4)])
    np.testing.assert_array_equal(stacked, s.batch(5)["tokens"])
    np.testing.assert_array_equal(
        s.batch(5)["tokens"], JTokenStream(vocab=100, seq_len=8, global_batch=8, seed=3).batch(5)
        ["tokens"])


def test_train_cli_on_cpu(capsys):
    state, hist = train_cli.main(["--arch", "tinyllama-1.1b", "--smoke", "--steps", "5",
                                  "--device", "cpu", "--global-batch", "4", "--seq-len", "16"])
    assert int(state["opt_step"]) == 5 and np.isfinite(hist[-1]["loss"])
    assert "step     5" in capsys.readouterr().out
    # --mesh trains sharded on spawned gloo ranks (test_torch_lm_distributed.py
    # holds its steps); a malformed shape is a usage error
    with pytest.raises(SystemExit):
        train_cli.main(["--arch", "tinyllama-1.1b", "--smoke", "--mesh", "2,x", "--device", "cpu"])
    assert train_cli.main(["--arch", "tinyllama-1.1b", "--smoke", "--mesh", "1,1", "--steps", "1",
                           "--device", "cpu", "--global-batch", "2", "--seq-len", "8"]) is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            train_cli.main(["--arch", "rwkv6-3b", "--smoke", "--steps", "1"])


def test_feature_selected_training_example_on_cpu():
    """The reduce-then-train example with its own checks, and its reduct
    against the JAX package's PLAR on the same table."""
    import importlib.util

    from repro.core import plar_reduce as j_plar_reduce
    from repro.data import TabularStream as JTabularStream

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "examples", "pt_feature_selected_training.py")
    spec = importlib.util.spec_from_file_location("pt_feature_selected_training", path)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    out = example.main(["--device", "cpu", "--steps", "40"])
    x, d = JTabularStream(n_rows=3000, n_attrs=48, v_max=4, n_dec=2, redundancy=0.5,
                          relevance=3, noise=0.02, seed=7).table()
    want = j_plar_reduce(x, d, delta="SCE", max_features=12)
    assert (out["reduct"], out["core"]) == (list(want.reduct), list(want.core))
    assert out["runs"]["reduct"]["width"] == len(want.reduct) < out["runs"]["full"]["width"]
