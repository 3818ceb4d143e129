"""The training path on the card: the kernels under autograd, and a step card vs CPU.

Marked ``cuda``: every test takes the ``cuda_device`` fixture, which skips
with a reason where PyTorch sees no card (decided inside the fixture, never
at import).  On a machine with a card and ``nvcc``:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_train.py

The kernels write their outputs through ctypes, so only their
differentiable wrappers give q/k/v and the RWKV6 inputs a gradient; these
tests hold those wrappers against the plain versions' autograd on the same
card.  Tolerances: flash outputs as in ``test_torch_cuda_lm.py`` (f32 rtol
= atol = 2e-5; bf16 one output rounding, |d| <= 1e-2·|plain| + 2e-3),
its gradients within 1e-5·max|grad| (the backward is the same plain
recompute); RWKV6 outputs rtol = atol = 1e-4, its gradients within
1e-4·max|grad| (the backward differentiates the chunked form of the same
recurrence).  A training step's loss card vs CPU within 1e-5·|loss|, every
gradient leaf within 1e-4·max|grad| (f32, TF32 off).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import attention_ref, flash_attention_diff
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.rwkv6 import ops as rwkv_ops
from repro_torch.kernels.rwkv6 import rwkv6_diff, rwkv6_ref
from repro_torch.models import build_model
from repro_torch.train import TrainConfig, Trainer

pytestmark = pytest.mark.cuda

FLASH_SHAPES = [  # b, hq, hkv, s, dh, causal, window, dtype
    (2, 4, 2, 128, 64, True, None, torch.bfloat16),
    (1, 4, 2, 256, 64, True, 48, torch.bfloat16),
    (1, 2, 1, 96, 128, False, None, torch.bfloat16),
    (2, 4, 2, 100, 32, True, None, torch.float32),
    (1, 32, 4, 2048, 64, True, None, torch.bfloat16),   # tinyllama-1.1b heads
]
RWKV_SHAPES = [  # b, h, t, d, decays
    (2, 2, 64, 16, "sigmoid"), (1, 3, 37, 32, "model"), (2, 2, 5, 64, "sigmoid"),
    (1, 40, 1024, 64, "model"),                          # rwkv6-3b heads
]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _grads(fn, inputs, cotangents):
    ins = [t.detach().clone().requires_grad_() for t in inputs]
    outs = fn(*ins)
    outs = outs if isinstance(outs, tuple) else (outs,)
    grads = torch.autograd.grad(outs, ins, cotangents)
    return [o.detach() for o in outs], grads


def _within(got, want, rel, what):
    scale = float(want.float().abs().max())
    err = float((got.float() - want.float()).abs().max())
    assert scale > 0 and err <= rel * scale, (what, err, scale)


@pytest.mark.parametrize("b,hq,hkv,s,dh,causal,window,dtype", FLASH_SHAPES)
def test_flash_attention_diff_on_card(cuda_device, b, hq, hkv, s, dh, causal, window, dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(s + dh)
    q, k, v = (torch.randn(shape, generator=gen, device=cuda_device).to(dtype)
               for shape in ((b, hq, s, dh), (b, hkv, s, dh), (b, hkv, s, dh)))
    g = torch.randn((b, hq, s, dh), generator=gen, device=cuda_device).to(dtype)
    opts = dict(causal=causal, window=window)
    flash_ops.reset_launch_counts()
    (o,), grads = _grads(lambda *a: flash_attention_diff(*a, **opts), (q, k, v), (g,))
    counts = flash_ops.launch_counts()
    assert counts["flash_attention"] == 1
    assert counts["flash_attention_tc"] == int(flash_ops.takes_tensor_cores(dtype, dh))
    (o_ref,), grads_ref = _grads(lambda *a: attention_ref(*a, **opts), (q, k, v), (g,))
    d = (o.float() - o_ref.float()).abs()
    if dtype == torch.bfloat16:
        assert bool((d <= 1e-2 * o_ref.float().abs() + 2e-3).all()), float(d.max())
    else:
        assert torch.allclose(o, o_ref, rtol=2e-5, atol=2e-5), float(d.max())
    for got, want, name in zip(grads, grads_ref, "qkv"):
        assert float(got.float().abs().max()) > 0, name
        _within(got, want, 1e-5, f"d{name}")


@pytest.mark.parametrize("b,h,t,d,decays", RWKV_SHAPES)
def test_rwkv6_diff_on_card(cuda_device, b, h, t, d, decays):
    gen = torch.Generator(device=cuda_device).manual_seed(t + d)
    rnd = lambda *shape: torch.randn(shape, generator=gen, device=cuda_device)  # noqa: E731
    r, k, v = rnd(b, h, t, d) * 0.5, rnd(b, h, t, d) * 0.5, rnd(b, h, t, d) * 0.5
    if decays == "model":
        w = torch.exp(-torch.exp(torch.rand((b, h, t, d), generator=gen, device=cuda_device)
                                 * 12 - 8))
    else:
        w = torch.sigmoid(rnd(b, h, t, d))
    u, s0 = rnd(h, d) * 0.5, rnd(b, h, d, d) * 0.1
    cot = (rnd(b, h, t, d), rnd(b, h, d, d))
    rwkv_ops.reset_launch_counts()
    (o, s), grads = _grads(rwkv6_diff, (r, k, v, w, u, s0), cot)
    path = "rwkv6_decode" if t < rwkv_ops.CHUNK else "rwkv6_chunked"
    assert rwkv_ops.launch_counts()[path] == 1
    (o_ref, s_ref), grads_ref = _grads(rwkv6_ref, (r, k, v, w, u, s0), cot)
    assert torch.allclose(o, o_ref, rtol=1e-4, atol=1e-4)
    assert torch.allclose(s, s_ref, rtol=1e-4, atol=1e-4)
    for got, want, name in zip(grads, grads_ref, ("r", "k", "v", "w", "u", "s0")):
        assert bool(torch.isfinite(got).all()), name
        _within(got, want, 1e-4, f"d{name}")


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "rwkv6-3b"])
def test_train_step_gradients_card_vs_cpu(cuda_device, arch):
    """Two layers of the reduced config in f32: the loss and every
    gradient leaf on the card equal the CPU's, and none is zero."""
    cfg = dataclasses.replace(get_config(arch).reduced(), n_layers=2)
    cpu = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    card = build_model(cfg, device=cuda_device)
    card.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab, (2, 40))
    out = {}
    for name, model in (("cpu", cpu), ("cuda", card)):
        model.requires_grad_(True)
        dev = model.device
        batch = {"tokens": torch.as_tensor(toks, device=dev),
                 "labels": torch.as_tensor(np.roll(toks, -1, 1), device=dev)}
        flash_ops.reset_launch_counts()
        rwkv_ops.reset_launch_counts()
        loss, _ = model.loss(batch)
        names, params = zip(*model.named_parameters())
        grads = torch.autograd.grad(loss, params)
        out[name] = (float(loss.detach()), {n: g.cpu() for n, g in zip(names, grads)})
        if name == "cuda":
            key = "flash_attention" if arch == "tinyllama-1.1b" else "rwkv6_chunked"
            counts = {**flash_ops.launch_counts(), **rwkv_ops.launch_counts()}
            assert counts[key] == cfg.n_layers, counts
    assert abs(out["cuda"][0] - out["cpu"][0]) <= 1e-5 * abs(out["cpu"][0])
    for n, g in out["cpu"][1].items():
        assert float(out["cuda"][1][n].abs().max()) > 0, n
        _within(out["cuda"][1][n], g, 1e-4, f"grad {n}")


def test_bf16_tensor_core_step_gives_every_leaf_a_gradient(cuda_device, tmp_path):
    """Two bf16 layers at head width 64 (the tensor-core flash kernel),
    three Trainer steps with remat: every leaf, wq/wk/wv/wo included, moves."""
    cfg = dataclasses.replace(get_config("tinyllama-1.1b").reduced(), n_layers=2, head_dim=64,
                              param_dtype="bfloat16", compute_dtype="bfloat16", remat=True)
    from repro_torch.data import TokenStream
    trainer = Trainer(cfg, TrainConfig(peak_lr=1e-2, warmup_steps=1, total_steps=3,
                                       ckpt_dir=str(tmp_path)), device=cuda_device)
    before = {k: t.detach().clone() for k, t in trainer.model.state_dict().items()}
    flash_ops.reset_launch_counts()
    stream = TokenStream(vocab=cfg.vocab, seq_len=128, global_batch=2, seed=0)
    state, hist = trainer.fit(stream.batch, steps=3)
    assert flash_ops.launch_counts()["flash_attention_tc"] > 0
    assert np.isfinite(hist[-1]["loss"])
    for k, t in state["params"].items():
        assert not torch.equal(t.detach(), before[k]), k
        assert float(state["opt_v"][k].abs().max()) > 0, k
