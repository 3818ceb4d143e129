"""Every LM family of the port against the JAX package, at the reduced size.

All ten architectures (dense, MoE with and without a shared expert, the
Mamba hybrid with MoE, RWKV6, the vision-frontend VLM and the audio
encoder-decoder), f32, on the CPU: the kernel wrappers take their plain
versions there, and the JAX side runs its Pallas kernels in interpret mode,
as the JAX package's own tests do.  Both packages get the same parameters
(drawn with numpy per JAX leaf, carried over with ``params_from_jax``) and
the same numpy-seeded inputs.  The JAX functions are jitted once per
architecture and shared through cached helpers.

Tolerances: logits (forward, prefill, two decode steps) within rtol = atol
= 1e-4; the loss within 1e-5 relative; every gradient leaf within
1e-4·max|JAX grad| of the leaf, or twice the port's own f32 floor there
where that is larger (see the gradient test), and nonzero.  The MoE and
Mamba modules alone (``tests/test_torch_families_modules.py``) are held
tighter.
"""
import dataclasses
import functools
import zlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as j_get_config
from repro.models import build_model as j_build_model
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import EncDecLM, build_model
from repro_torch.models.convert import params_from_jax, params_to_jax
from test_torch_lm import _seeded_params as seeded_params

torch.set_num_threads(1)

B, S = 2, 12                 # prefill length; forward and the decode steps run S + 2
NEW_FAMILIES = ["qwen3-moe-235b-a22b", "kimi-k2-1t-a32b", "jamba-1.5-large-398b",
                "llava-next-34b", "seamless-m4t-medium"]


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def close(got, want, what, rtol=1e-4, atol=1e-4):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=what)


def close_rel(got, want, what, rel):
    """max|got - want| <= rel·max|want|."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert scale > 0 and err <= rel * scale, (what, err, scale)


class Pair:
    """One architecture in both packages with the same parameters, and one
    numpy-seeded batch: tokens [B, S + 2], labels, a loss mask, and the
    frontend's features or the encoder's frames."""

    def __init__(self, arch):
        self.cfg = get_config(arch).reduced()
        self.j_cfg = j_get_config(arch).reduced()
        self.j_model = j_build_model(self.j_cfg)
        self.j_params = seeded_params(self.j_model, 7)
        self.model = build_model(self.cfg, device="cpu")
        self.model.load_state_dict(params_from_jax(self.cfg, np_tree(self.j_params)))
        rng = np.random.default_rng(zlib.crc32(arch.encode()))
        cfg = self.cfg
        self.batch = {
            "tokens": rng.integers(0, cfg.vocab, (B, S + 2)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab, (B, S + 2)).astype(np.int32),
            "loss_mask": (np.arange(S + 2)[None] % 5 != 0).repeat(B, 0).astype(np.float32),
        }
        if cfg.frontend == "vision":
            self.batch["frontend_feats"] = rng.standard_normal(
                (B, cfg.frontend_tokens, cfg.frontend_dim)).astype(np.float32)
        if cfg.is_encdec:
            self.batch["frames"] = rng.standard_normal((B, 10, cfg.frontend_dim)).astype(
                np.float32)

    def j_batch(self, **over):
        return {k: jnp.asarray(v) for k, v in {**self.batch, **over}.items()}

    def t_batch(self, **over):
        return {k: torch.from_numpy(np.asarray(v)) for k, v in {**self.batch, **over}.items()}


@functools.lru_cache(maxsize=None)
def pair(arch):
    return Pair(arch)


@functools.lru_cache(maxsize=None)
def jax_serving(arch):
    """JAX's forward logits, prefill output and two decode steps' logits."""
    p = pair(arch)
    m, params, cache_len = p.j_model, p.j_params, S + 4
    toks = p.batch["tokens"]
    if p.cfg.is_encdec:
        full = jax.jit(lambda pr, b: m._logits(pr, m._decode_stack_full(
            pr, b["tokens"], m.encode(pr, b["frames"]))))(params, p.j_batch())
        cache, lengths = jax.jit(m.prefill, static_argnums=2)(
            params, {"frames": jnp.asarray(p.batch["frames"])}, cache_len)
        pre = cache
        steps = toks[:, :2]
    else:
        full = jax.jit(m.forward)(params, p.j_batch())
        pre, cache, lengths = jax.jit(m.prefill, static_argnums=2)(
            params, p.j_batch(tokens=toks[:, :S]), cache_len)
        steps = toks[:, S:S + 2]
    decode = jax.jit(m.decode)
    logits = []
    for t in range(2):
        lg, cache, lengths = decode(params, cache, jnp.asarray(steps[:, t:t + 1]), lengths)
        logits.append(np.asarray(lg))
    return np.asarray(full), np_tree(pre), logits, np_tree(cache), np.asarray(lengths)


@functools.lru_cache(maxsize=None)
def jax_grads(arch):
    p = pair(arch)
    (loss, _), grads = jax.jit(jax.value_and_grad(p.j_model.loss, has_aux=True))(
        p.j_params, p.j_batch())
    return float(loss), np_tree(grads)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_forward_prefill_and_decode_match_jax(arch):
    """Forward logits over S + 2 tokens; prefill over S (the enc-dec: the
    encoder memory's cross K/V and the empty self cache); two decode steps'
    logits; the cache after them."""
    p = pair(arch)
    j_full, j_pre, j_steps, j_cache, j_len = jax_serving(arch)
    toks = torch.from_numpy(p.batch["tokens"])
    cache_len = S + 4
    with torch.inference_mode():
        close(p.model(p.t_batch()), j_full, f"{arch} forward logits")
        if p.cfg.is_encdec:
            cache, lengths = p.model.prefill(p.t_batch(), cache_len)
            for key in ("cross_k", "cross_v", "k", "v"):
                close(cache[key], j_pre[key], f"{arch} prefill cache {key}")
            steps = toks[:, :2]
        else:
            logits, cache, lengths = p.model.prefill(p.t_batch(tokens=p.batch["tokens"][:, :S]),
                                                     cache_len)
            close(logits, j_pre, f"{arch} prefill logits")
            steps = toks[:, S:S + 2]
        for t in range(2):
            logits, cache, lengths = p.model.decode(cache, steps[:, t:t + 1], lengths)
            close(logits, j_steps[t], f"{arch} decode step {t} logits")
    np.testing.assert_array_equal(lengths.numpy(), j_len)
    flat = {"": cache} if p.cfg.is_encdec else cache
    j_flat = {"": j_cache} if p.cfg.is_encdec else j_cache
    for pos, leaves in flat.items():
        assert set(leaves) == set(j_flat[pos]), (arch, pos)
        for key, leaf in leaves.items():
            assert leaf.dtype == torch.float32 or key != "ssm"
            close(leaf, j_flat[pos][key], f"{arch} cache {pos}/{key}")


def port_grads(p, perturb=None, cfg=None):
    """(loss, metrics, {name: grad}) of the port's masked loss, its
    parameters carried from JAX (each times ``1 + perturb[name]`` if given),
    under ``cfg`` (the pair's by default)."""
    model = build_model(cfg or p.cfg, device="cpu")
    state = params_from_jax(p.cfg, np_tree(p.j_params))
    if perturb is not None:
        state = {k: v * (1 + perturb[k]) for k, v in state.items()}
    model.load_state_dict(state)
    model.requires_grad_(True)
    loss, metrics = model.loss(p.t_batch())
    names, params = zip(*model.named_parameters())
    return loss.detach(), metrics, dict(zip(names, torch.autograd.grad(loss, params)))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_loss_and_gradients_match_jax(arch):
    """The masked loss and every parameter's gradient, as
    ``tests/test_archs.py::test_smoke_forward_and_grad`` takes them in JAX.

    Each leaf within max(1e-4, 2·floor)·max|JAX grad|, the floor being how
    far the port's own gradient of that leaf moves when every parameter is
    scaled by 1 + N(0, 1)·1.2e-7 (about one f32 rounding): where the
    backward amplifies rounding, as rwkv6's does at this batch (one rounding
    moves its layer-0 gradients by ~1e-3 of their max), no f32
    implementation holds 1e-4; elsewhere the floor is far below 1e-4."""
    p = pair(arch)
    j_loss, j_grads = jax_grads(arch)
    loss, metrics, grads = port_grads(p)
    gen = torch.Generator().manual_seed(0)
    noise = {k: 1.2e-7 * torch.randn(v.shape, generator=gen)
             for k, v in p.model.state_dict().items()}
    _, _, moved = port_grads(p, noise)
    assert abs(float(loss) - j_loss) <= 1e-5 * abs(j_loss), (float(loss), j_loss)
    assert 0.0 <= float(metrics["accuracy"]) <= 1.0
    want = params_from_jax(p.cfg, j_grads)
    assert set(want) == set(grads)
    for name, g in grads.items():
        assert bool(torch.isfinite(g).all()), (arch, name)
        assert float(g.abs().max()) > 0.0, (arch, name, "dead grad")
        scale = float(want[name].abs().max())
        floor = float((moved[name] - g).abs().max()) / scale
        close_rel(g, want[name], f"{arch} grad {name} (floor {floor:.2e})", max(1e-4, 2 * floor))


def test_encdec_decode_matches_jax_and_teacher_forcing():
    """Greedy-free decode of 5 given tokens against the encoder memory, one
    at a time: each step's logits equal JAX's step and the port's own
    teacher-forced logits (``tests/test_archs.py:94-114``)."""
    p = pair("seamless-m4t-medium")
    m, params = p.j_model, p.j_params
    rng = np.random.default_rng(3)
    frames = rng.standard_normal((B, 10, p.cfg.frontend_dim)).astype(np.float32)
    toks = rng.integers(0, p.cfg.vocab, (B, 5)).astype(np.int32)
    j_cache, j_len = jax.jit(m.prefill, static_argnums=2)(
        params, {"frames": jnp.asarray(frames)}, 7)
    j_decode = jax.jit(m.decode)
    with torch.inference_mode():
        full = p.model({"tokens": torch.from_numpy(toks), "frames": torch.from_numpy(frames)})
        cache, lengths = p.model.prefill({"frames": torch.from_numpy(frames)}, 7)
        for t in range(5):
            j_lg, j_cache, j_len = j_decode(params, j_cache, jnp.asarray(toks[:, t:t + 1]), j_len)
            lg, cache, lengths = p.model.decode(cache, torch.from_numpy(toks[:, t:t + 1]), lengths)
            close(lg[:, 0], j_lg[:, 0], f"decode step {t} vs JAX")
            close(lg[:, 0], full[:, t], f"decode step {t} vs teacher forcing")
    assert isinstance(p.model, EncDecLM)


@pytest.mark.parametrize("arch", NEW_FAMILIES)
def test_params_round_trip_to_the_jax_tree(arch):
    """``params_to_jax(params_from_jax(tree))`` is the JAX tree leaf for leaf,
    and ``params_from_jax`` names every parameter of the port's model."""
    p = pair(arch)
    tree = np_tree(p.j_params)
    state = params_from_jax(p.cfg, tree)
    assert set(state) == set(p.model.state_dict())
    back = params_to_jax(p.cfg, state)
    want = jax.tree_util.tree_flatten_with_path(tree)[0]
    got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert set(got) == {path for path, _ in want}
    for path, leaf in want:
        assert got[path].shape == leaf.shape and got[path].dtype == leaf.dtype, path
        np.testing.assert_array_equal(got[path], leaf, err_msg=str(path))


def test_encdec_remat_keeps_gradients():
    """``EncDecLM`` recomputes each layer in the backward under
    ``cfg.remat`` (JAX checkpoints its scan bodies): the same loss and
    gradients, bit for bit."""
    p = pair("seamless-m4t-medium")
    assert not p.cfg.remat
    loss, _, want = port_grads(p)
    loss_r, _, got = port_grads(p, cfg=dataclasses.replace(p.cfg, remat=True))
    assert float(loss_r) == float(loss)
    for name, g in got.items():
        assert torch.equal(g, want[name]), name
