"""The port's MoE and Mamba modules alone against the JAX package's.

At the reduced widths of qwen3-moe (4 experts, top-2), kimi-k2 (the same
with one shared expert) and jamba (Di 256, Ds 16, dt rank 8), f32 on the
CPU, with the parameters of the reduced models' first MoE and Mamba layers
drawn with numpy per JAX leaf (``tests/test_torch_families.py``).

* ``moe``: a drop case (t = 48 > 32 tokens, the router skewed onto expert 0
  so that its capacity, int(48·2/4·1.25) = 30, drops pairs), the decode
  regime (t ≤ 32: capacity t, no drop), and exact ties (router columns
  duplicated, so logits tie bit for bit): the port's expert ids equal
  ``jax.lax.top_k``'s exactly (and so do the pairs that keep their
  capacity), and the output is within 1e-5·max|JAX|.
* ``mamba``: T not a multiple of the chunk with chunk < T, T below the
  chunk, and decode steps continuing from the prefill's (conv, ssm) state,
  each within 1e-5·max|JAX| (outputs and states); the chunked scan alone
  likewise.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as j_get_config
from repro.models import build_model as j_build_model
from repro.models.moe import moe as j_moe
from repro.models.ssm import _ssm_chunk_scan as j_chunk_scan
from repro.models.ssm import mamba as j_mamba
from repro_torch.configs import get_config
from repro_torch.models.moe import capacity, moe, route
from repro_torch.models.ssm import _ssm_chunk_scan, mamba
from test_torch_families import close_rel, np_tree, seeded_params

torch.set_num_threads(1)

REL = 1e-5


def close(got, want, what):
    close_rel(got, want, what, REL)


def layer_params(arch, pos, key):
    """(port cfg, JAX cfg, numpy params of blocks/pos{pos}/{key}, period 0)."""
    j_cfg = j_get_config(arch).reduced()
    tree = np_tree(seeded_params(j_build_model(j_cfg), 7))
    layer = tree["blocks"][f"pos{pos}"][key]
    params = {k: np.array(np.asarray(v)[0]) for k, v in layer.items()}
    return get_config(arch).reduced(), j_cfg, params


def torch_params(params):
    return {k: torch.from_numpy(v) for k, v in params.items()}


def kept_pairs(eids, t, cap):
    """{(token, expert)} that keep their expert: earlier tokens first."""
    seen, kept = {}, set()
    for tok in range(t):
        for e in eids[tok]:
            seen[e] = seen.get(e, 0) + 1
            if seen[e] <= cap:
                kept.add((tok, int(e)))
    return kept


@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "kimi-k2-1t-a32b"])
@pytest.mark.parametrize("case", ["drop", "decode", "ties"])
def test_moe_matches_jax(arch, case):
    cfg, j_cfg, params = layer_params(arch, 0, "ffn")
    assert ("shared_wg" in params) == (arch.startswith("kimi"))
    rng = np.random.default_rng(["drop", "decode", "ties"].index(case))
    d = cfg.d_model
    if case == "drop":
        x = rng.standard_normal((2, 24, d)).astype(np.float32)
        u = x.reshape(-1, d).mean(0)
        params["router"][:, 0] += 4 * u / float(u @ u)     # every token leans to expert 0
    elif case == "decode":
        x = rng.standard_normal((4, 1, d)).astype(np.float32)
    else:
        x = rng.standard_normal((2, 24, d)).astype(np.float32)
        router = params["router"]
        router[:, 1], router[:, 3] = router[:, 0], router[:, 2]
    t = x.shape[0] * x.shape[1]
    x2d = x.reshape(t, d)

    j_logits = np.asarray(jnp.asarray(x2d) @ jnp.asarray(params["router"]))
    _, j_ids = jax.lax.top_k(jnp.asarray(j_logits), cfg.top_k)
    j_ids = np.asarray(j_ids)
    gates, ids = route(torch.from_numpy(x2d), torch.from_numpy(params["router"]), cfg)
    np.testing.assert_array_equal(ids.numpy(), j_ids)
    assert np.allclose(gates.sum(-1).numpy(), 1.0)
    cap = capacity(t, cfg)
    kept = kept_pairs(j_ids, t, cap)
    if case == "drop":
        assert cap == int(t * cfg.top_k / cfg.n_experts * cfg.capacity_factor) == 30
        assert len(kept) < t * cfg.top_k, "no pair was dropped"
    elif case == "decode":
        assert cap == t and len(kept) == t * cfg.top_k
    else:
        ties = (j_logits[:, 0] == j_logits[:, 1]) & (j_logits[:, 2] == j_logits[:, 3])
        assert ties.all(), "duplicated router columns did not tie"
        assert any({0, 1} <= set(row) or {2, 3} <= set(row) for row in j_ids)

    want = j_moe({k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x), j_cfg)
    got = moe(torch_params(params), torch.from_numpy(x), cfg)
    close(got, want, f"{arch} moe ({case})")


def test_moe_expert_parallel_options_raise():
    """The expert-parallel options run: ``moe_weight_stationary`` without a
    mesh takes the local path, JAX's selection (``moe.py:220-231``), equal
    to JAX's ``moe`` with the option on; the mesh paths are held on gloo
    ranks by ``test_torch_lm_distributed_moe.py``."""
    cfg, j_cfg, params = layer_params("qwen3-moe-235b-a22b", 0, "ffn")
    x = np.random.default_rng(2).standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    ws = dataclasses.replace(cfg, moe_weight_stationary=True)
    j_ws = dataclasses.replace(j_cfg, moe_weight_stationary=True)
    want = j_moe({k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x), j_ws)
    got = moe(torch_params(params), torch.from_numpy(x), ws)
    close(got, want, "moe with moe_weight_stationary, no mesh")
    assert torch.equal(got, moe(torch_params(params), torch.from_numpy(x), cfg))


def _jax_mamba(j_cfg, params, x, **kw):
    kw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    out = j_mamba({k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x), j_cfg,
                  return_state=True, **kw)
    return jax.tree.map(np.asarray, out)


def _mamba_both(cfg, j_cfg, params, x, **kw):
    got = mamba(torch_params(params), torch.from_numpy(x), cfg, return_state=True, **kw)
    return got, _jax_mamba(j_cfg, params, x, **kw)


@pytest.mark.parametrize("t,chunk", [(21, 8), (21, 256)])
def test_mamba_matches_jax(t, chunk):
    """T = 21 in chunks of 8 (the tail padded with a = 1) and in one chunk."""
    cfg, j_cfg, params = layer_params("jamba-1.5-large-398b", 0, "mamba")
    assert cfg.ssm_d_inner == 256 and cfg.dt_rank == 8
    x = np.random.default_rng(t + chunk).standard_normal((2, t, cfg.d_model)).astype(np.float32)
    (out, (conv, ssm)), (j_out, (j_conv, j_ssm)) = _mamba_both(cfg, j_cfg, params, x,
                                                             chunk=chunk)
    close(out, j_out, f"mamba out T={t} chunk={chunk}")
    close(conv, j_conv, "conv state")
    close(ssm, j_ssm, "ssm state")
    assert conv.shape == (2, cfg.ssm_d_conv - 1, cfg.ssm_d_inner) and ssm.dtype == torch.float32


def test_mamba_decode_continues_the_prefill_state():
    """A prefill of 13 tokens, then 3 one-token steps from its (conv, ssm)
    state, each against JAX's step from JAX's state; the steps together
    equal the 16-token prefill's last outputs."""
    cfg, j_cfg, params = layer_params("jamba-1.5-large-398b", 0, "mamba")
    x = np.random.default_rng(5).standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    (out, (conv, ssm)), (j_out, (j_conv, j_ssm)) = _mamba_both(cfg, j_cfg, params, x[:, :13],
                                                             chunk=8)
    close(out, j_out, "prefill out")
    steps = []
    for i in range(13, 16):
        x_i = x[:, i:i + 1]
        o, (conv, ssm) = mamba(torch_params(params), torch.from_numpy(x_i), cfg,
                               conv_state=conv, ssm_state=ssm, return_state=True)
        j_o, (j_conv, j_ssm) = _jax_mamba(j_cfg, params, x_i, conv_state=j_conv,
                                          ssm_state=j_ssm)
        close(o, j_o, f"decode step {i} out")
        close(conv, j_conv, f"decode step {i} conv state")
        close(ssm, j_ssm, f"decode step {i} ssm state")
        steps.append(o)
    full = mamba(torch_params(params), torch.from_numpy(x), cfg)
    close(torch.cat(steps, dim=1), full[:, 13:].numpy(), "decode steps vs one prefill")


def test_ssm_chunk_scan_matches_jax():
    """The chunked scan alone: T = 37 in chunks of 16, from a nonzero h0."""
    rng = np.random.default_rng(9)
    a = rng.uniform(0.5, 1.0, (2, 37, 8, 4)).astype(np.float32)
    bu = rng.standard_normal((2, 37, 8, 4)).astype(np.float32)
    h0 = rng.standard_normal((2, 8, 4)).astype(np.float32)
    j_all, j_fin = j_chunk_scan(jnp.asarray(a), jnp.asarray(bu), jnp.asarray(h0), 16)
    h_all, h_fin = _ssm_chunk_scan(torch.from_numpy(a), torch.from_numpy(bu),
                                   torch.from_numpy(h0), 16)
    close(h_all, j_all, "h_all")
    close(h_fin, j_fin, "h_final")
