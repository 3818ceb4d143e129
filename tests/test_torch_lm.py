"""The port's LM serving path against the JAX package, at the reduced size.

Reduced tinyllama (attention + SwiGLU, GQA) and rwkv6 (RWKV6 time-mix and
channel-mix), both f32, on the CPU: every kernel wrapper takes its plain
version, and the JAX side runs its Pallas kernels in interpret mode.  Both
packages get the same parameters, carried over with ``params_from_jax``
inside this process.  The parameter tree is drawn with numpy from a seed
for each leaf of the JAX ``param_defs`` (the JAX init seeds from Python's
salted ``hash``, so it differs from one process to the next; one test hands
``params_from_jax`` a JAX ``model.init`` tree as it comes).  The JAX runs
are shared through module-scoped fixtures.

Tolerances: logits within atol = 1e-4·max|JAX logit| and rtol = 1e-4;
module outputs and cache leaves within the same relative bound; served
tokens equal.
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
from repro.models.attention import self_attention_decode as j_attn_decode
from repro.models.attention import self_attention_full as j_attn_full
from repro.models.layers import ParamDef as JParamDef
from repro.models.rwkv import rwkv_time_mix as j_time_mix
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JServingEngine
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch import serve as serve_cli
from repro_torch.models import build_model
from repro_torch.models.attention import self_attention_decode, self_attention_full
from repro_torch.models.convert import params_from_jax
from repro_torch.models.rwkv import rwkv_time_mix
from repro_torch.serving import Request, ServingEngine

torch.set_num_threads(1)

ARCHS = ["tinyllama-1.1b", "rwkv6-3b"]
CACHE_LEN = 48
# 3 rows sit below the JAX package's 8-row Pallas rule, 9-20 above it;
# repeated lengths spare JAX compiles
PROMPT_LENS = [3, 9, 14, 20, 9, 3]


def _close(got, want, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = float(np.abs(want).max())
    assert scale > 0, what
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * scale, err_msg=what)


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


class Pair:
    """One architecture in both packages with the same parameters."""

    def __init__(self, arch):
        self.cfg = get_config(arch).reduced()
        self.j_cfg = j_get_config(arch).reduced()
        self.j_model = j_build_model(self.j_cfg)
        self.j_params = _seeded_params(self.j_model, 7)
        self.model = build_model(self.cfg, device="cpu")
        self.model.load_state_dict(
            params_from_jax(self.cfg, jax.tree.map(np.asarray, self.j_params)))
        rng = np.random.default_rng(3)
        self.prompts = [rng.integers(0, self.cfg.vocab, n) for n in PROMPT_LENS]


@functools.lru_cache(maxsize=None)
def _pair(arch):
    return Pair(arch)


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    return _pair(request.param)


@pytest.fixture(scope="module")
def served(pair):
    """Both engines over 6 requests (max_batch 3, budgets 2-7), request 0
    with an EOS that the port's own first run says it meets at its third
    token."""
    budgets = [6, 4, 7, 2, 5, 6]

    def port_serve(eos):
        reqs = [Request(rid=i, prompt=p, max_new_tokens=n, eos_id=eos if i == 0 else None)
                for i, (p, n) in enumerate(zip(pair.prompts, budgets))]
        return ServingEngine(pair.cfg, pair.model, max_batch=3, cache_len=CACHE_LEN,
                             device="cpu").serve(reqs)

    eos = port_serve(None)[0].output[2]
    port = port_serve(eos)
    jreqs = [JRequest(rid=i, prompt=p, max_new_tokens=n, eos_id=eos if i == 0 else None)
             for i, (p, n) in enumerate(zip(pair.prompts, budgets))]
    jax_out = JServingEngine(pair.j_cfg, pair.j_params, max_batch=3,
                             cache_len=CACHE_LEN).serve(jreqs)
    return port, jax_out, eos


def test_served_tokens_equal_jax(served):
    port, jax_out, _ = served
    assert [r.output for r in port] == [r.output for r in jax_out]
    assert all(len(r.output) == r.max_new_tokens for r in port[1:])


def test_served_early_eos(served):
    port, jax_out, eos = served
    assert port[0].output[-1] == eos and len(port[0].output) <= 3
    assert jax_out[0].output == port[0].output


@pytest.mark.parametrize("prompt_len,cache_len", [(3, CACHE_LEN), (13, 16)])
def test_prefill_and_decode_logits_match_jax(pair, prompt_len, cache_len):
    """Prefill, then decode steps of 1, 3, 1 and 1 new tokens for a batch of
    2: 3 prompt rows take the plain attention; 13 rows take the flash
    wrapper, and with cache_len 16 the writes of the 3-token step and the
    later ones run past the cache's end (both packages drop them)."""
    rng = np.random.default_rng(prompt_len + cache_len)
    toks = rng.integers(0, pair.cfg.vocab, (2, prompt_len))
    steps = [rng.integers(0, pair.cfg.vocab, (2, n)) for n in (1, 3, 1, 1)]
    jl, jc, jlen = pair.j_model.prefill(pair.j_params, {"tokens": jnp.asarray(toks, jnp.int32)},
                                        cache_len=cache_len)
    with torch.inference_mode():
        tl, tc, tlen = pair.model.prefill(torch.from_numpy(toks), cache_len)
        _close(tl, jl, "prefill logits")
        for i, step in enumerate(steps):
            jl, jc, jlen = pair.j_model.decode(pair.j_params, jc, jnp.asarray(step, jnp.int32),
                                               jlen)
            tl, tc, tlen = pair.model.decode(tc, torch.from_numpy(step), tlen)
            _close(tl, jl, f"decode step {i} logits")
    np.testing.assert_array_equal(tlen.numpy(), np.asarray(jlen))
    for pos, leaves in jc.items():
        for key, leaf in leaves.items():
            _close(tc[pos][key], leaf, f"cache {pos}/{key}")


def _layer0(pair, key):
    return jax.tree.map(lambda a: a[0], pair.j_params["blocks"]["pos0"][key])


def test_attention_module_matches_jax():
    """self_attention_full (the flash wrapper at 12 rows) and
    self_attention_decode of layer 0."""
    p = _pair("tinyllama-1.1b")
    cfg, blk = p.cfg, p.model.blocks[0]["attn"]
    rng = np.random.default_rng(0)
    for s in (12,):
        x = (rng.standard_normal((2, s, cfg.d_model)) * 0.5).astype(np.float32)
        pos = np.tile(np.arange(s), (2, 1))
        jo, (jk, jv) = j_attn_full(_layer0(p, "attn"), jnp.asarray(x), jnp.asarray(pos), p.j_cfg,
                                   return_kv=True)
        to, (tk, tv) = self_attention_full(blk, torch.from_numpy(x), torch.from_numpy(pos), cfg,
                                           return_kv=True)
        for got, want, what in ((to, jo, "out"), (tk, jk, "k"), (tv, jv, "v")):
            _close(got, want, f"attention full s={s} {what}")
    cache = (rng.standard_normal((2, 2, 16, 2, cfg.hd)) * 0.5).astype(np.float32)
    lengths = np.array([4, 9], np.int32)
    x = (rng.standard_normal((2, 1, cfg.d_model)) * 0.5).astype(np.float32)
    jo, jck, jcv = j_attn_decode(_layer0(p, "attn"), jnp.asarray(x), p.j_cfg,
                                 jnp.asarray(cache[0]).transpose(0, 2, 1, 3),
                                 jnp.asarray(cache[1]).transpose(0, 2, 1, 3), jnp.asarray(lengths))
    ck = torch.from_numpy(cache[0]).permute(0, 2, 1, 3).contiguous()
    cv = torch.from_numpy(cache[1]).permute(0, 2, 1, 3).contiguous()
    to, tck, tcv = self_attention_decode(blk, torch.from_numpy(x), cfg, ck, cv,
                                         torch.from_numpy(lengths))
    for got, want, what in ((to, jo, "out"), (tck, jck, "k cache"), (tcv, jcv, "v cache")):
        _close(got, want, f"attention decode {what}")


def test_rwkv_time_mix_matches_jax():
    """rwkv_time_mix of layer 0 over 10 tokens, then one decode step from
    the returned states."""
    p = _pair("rwkv6-3b")
    cfg, blk = p.cfg, p.model.blocks[0]["time_mix"]
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((2, 10, cfg.d_model)) * 0.5).astype(np.float32)
    jo, (jlast, jwkv) = j_time_mix(_layer0(p, "time_mix"), jnp.asarray(x), p.j_cfg,
                                   return_state=True)
    to, (tlast, twkv) = rwkv_time_mix(blk, torch.from_numpy(x), cfg, return_state=True)
    _close(to, jo, "time-mix out")
    _close(tlast, jlast, "shift state")
    _close(twkv, jwkv, "wkv state")
    x1 = (rng.standard_normal((2, 1, cfg.d_model)) * 0.5).astype(np.float32)
    jo, (_, jwkv) = j_time_mix(_layer0(p, "time_mix"), jnp.asarray(x1), p.j_cfg,
                               shift_state=jlast, wkv_state=jwkv, return_state=True)
    to, (_, twkv) = rwkv_time_mix(blk, torch.from_numpy(x1), cfg, shift_state=tlast,
                                  wkv_state=twkv, return_state=True)
    _close(to, jo, "time-mix decode out")
    _close(twkv, jwkv, "wkv state after decode")


@pytest.mark.parametrize("arch", ["rwkv6-3b"])   # the tree with f32 leaves in it
def test_params_from_jax_takes_a_jax_init_tree(arch):
    cfg, j_cfg = get_config(arch).reduced(), j_get_config(arch).reduced()
    j_model = j_build_model(j_cfg)
    j_params = j_model.init(jax.random.PRNGKey(0))
    model = build_model(cfg, device="cpu")
    state = params_from_jax(cfg, jax.tree.map(np.asarray, j_params))
    assert set(state) == set(model.state_dict())
    model.load_state_dict(state)
    toks = np.random.default_rng(2).integers(0, cfg.vocab, (1, 10))
    want = j_model.forward(j_params, {"tokens": jnp.asarray(toks, jnp.int32)})
    with torch.inference_mode():
        _close(model(torch.from_numpy(toks)), want, "forward logits")


def test_configs_resolve_and_every_family_builds():
    """Every config equals JAX's and builds the JAX package's model class;
    the MoE weight-stationary serving option builds, and without a mesh
    takes the local path, as JAX's (the same logits as the option off)."""
    for arch in ARCH_IDS:
        assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(j_get_config(arch))
        model = build_model(get_config(arch).reduced(), device="cpu")
        assert type(model).__name__ == type(j_build_model(j_get_config(arch).reduced())).__name__
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, 512, (2, 9)))
    for arch in ("qwen3-moe-235b-a22b", "kimi-k2-1t-a32b", "jamba-1.5-large-398b"):
        cfg = get_config(arch).reduced()
        ws = build_model(dataclasses.replace(cfg, moe_weight_stationary=True), device="cpu")
        with torch.inference_mode():
            assert torch.equal(ws(toks), build_model(cfg, device="cpu")(toks)), arch
    base = build_model(get_config("tinyllama-1.1b").reduced(), device="cpu")
    toks = torch.from_numpy(np.random.default_rng(4).integers(0, base.cfg.vocab, (2, 11)))
    with torch.inference_mode():
        want = base(toks)
        for option in ("attn_naive", "flash_bwd"):       # training / dry-run paths: built
            cfg = dataclasses.replace(base.cfg, **{option: True})
            _close(build_model(cfg, device="cpu")(toks), want, f"{option} forward logits")


def test_build_model_is_seeded_and_typed():
    cfg = get_config("rwkv6-3b").reduced()
    a = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(5))
    b = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(5))
    c = build_model(cfg, device="cpu", dtype=torch.bfloat16)
    for (name, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(x, y), name
    assert c.embed["embedding"].dtype == torch.bfloat16
    assert c.blocks[0]["time_mix"]["w0"].dtype == torch.float32   # the decay stays f32


def test_serve_cli_on_cpu(capsys):
    done = serve_cli.main(["--arch", "tinyllama-1.1b", "--smoke", "--device", "cpu",
                           "--requests", "3", "--max-new-tokens", "4", "--cache-len", "32"])
    assert [len(r.output) for r in done] == [4, 4, 4]
    assert capsys.readouterr().out.count("req ") == 3
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            serve_cli.main(["--arch", "rwkv6-3b", "--smoke"])
