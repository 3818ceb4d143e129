"""Mixture-of-Experts layer: sort-based capacity dispatch, one device.

The port of ``repro.models.moe``'s local path (``_moe_local`` with every
expert on this device, ``E_loc = E``): router logits → top-k → flatten the
(token, expert) pairs, stable-sort them by expert, rank each pair within its
expert, drop pairs past the per-expert capacity, gather the kept tokens into
an ``[E, C, D]`` buffer, two batched products and the down projection, and
combine each token's k expert outputs weighted by its gates.

Where the routing must equal ``jax.lax.top_k``'s bit for bit:

* ties: ``lax.top_k`` puts the lower expert index first; ``torch.topk``
  does not fix the order of ties on CUDA, so the top k are the first k of a
  stable descending ``torch.sort``;
* capacity: the same Python expression, ``int(t·k/E·capacity_factor)``,
  and the drop-free decode regime ``t ≤ 32`` → ``cap = t``;
* rank within an expert: a stable argsort by expert and ``searchsorted``,
  so earlier tokens win capacity;
* dropped pairs go to a spare last buffer row that is cut off (JAX's
  out-of-bounds slot with ``mode="drop"``).

The combine un-permutes the weighted expert outputs to ``[T, k, D]`` and
sums over k in f32 in index order, then casts (JAX scatter-adds in the
compute dtype; an ``index_add_`` on the card would add in whatever order
its atomics run).  Deterministic, and equal to JAX within f32 rounding.

Expert parallelism (the ``shard_map`` islands and the weight-stationary
serving path) is not ported: ``moe_weight_stationary`` or a model group
larger than one raises, never runs the local path in its place.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from .config import torch_dtype
from .layers import ParamDef
from .mlp import _act

EP_NOT_PORTED = "is not ported yet (ROADMAP §1 item 8: LM distribution)"


def moe_defs(cfg) -> Dict[str, ParamDef]:
    d, e, fe = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    dt = cfg.param_dtype
    defs = {
        "router": ParamDef((d, e), "fan_in", dt),
        "wg": ParamDef((e, d, fe), "fan_in", dt),
        "wu": ParamDef((e, d, fe), "fan_in", dt),
        "wd": ParamDef((e, fe, d), "fan_in", dt),
    }
    if cfg.n_shared_experts:
        fe_sh = cfg.moe_d_ff * cfg.n_shared_experts
        defs["shared_wg"] = ParamDef((d, fe_sh), "fan_in", dt)
        defs["shared_wu"] = ParamDef((d, fe_sh), "fan_in", dt)
        defs["shared_wd"] = ParamDef((fe_sh, d), "fan_in", dt)
    return defs


def capacity(t: int, cfg) -> int:
    """Per-expert capacity of ``t`` tokens (JAX ``moe.py:69-74``)."""
    if t <= 32:
        return t   # decode regime: one expert can take every token once, so no drops
    return max(1, int(t * cfg.top_k / cfg.n_experts * cfg.capacity_factor))


def route(x2d: torch.Tensor, router: torch.Tensor, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """Router logits → (softmaxed gates [T, k] f32, expert ids [T, k]),
    ties to the lower expert index (``jax.lax.top_k``'s order)."""
    cdt = torch_dtype(cfg.compute_dtype)
    logits = (x2d @ router.to(cdt)).float()                          # [T, E]
    vals, ids = torch.sort(logits, dim=-1, descending=True, stable=True)
    return torch.softmax(vals[:, :cfg.top_k], dim=-1), ids[:, :cfg.top_k]


def _moe_local(x2d, router, wg, wu, wd, cfg):
    """Tokens [T, D] × every expert's wg/wu/wd [E, ...] → [T, D]."""
    t, d = x2d.shape
    e, k = cfg.n_experts, cfg.top_k
    cdt = torch_dtype(cfg.compute_dtype)
    cap = capacity(t, cfg)
    dev = x2d.device

    gates, eids = route(x2d, router, cfg)
    flat_e = eids.reshape(-1)                                        # [T·k], token-major
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    rank = torch.arange(t * k, device=dev) - torch.searchsorted(se, se, side="left")
    keep_s = rank < cap
    slot_s = torch.where(keep_s, se * cap + rank, torch.full_like(se, e * cap))

    # gather the kept tokens; dropped pairs land on the spare last row
    buf = torch.zeros((e * cap + 1, d), dtype=cdt, device=dev)
    buf = buf.index_put((slot_s,), x2d[order // k].to(cdt))[:-1].reshape(e, cap, d)
    h = _act(torch.bmm(buf, wg.to(cdt)), cfg.activation) * torch.bmm(buf, wu.to(cdt))
    y = torch.bmm(h, wd.to(cdt)).reshape(e * cap, d)

    # back to pair order [T, k]; a dropped pair's weight is 0
    inv = torch.empty_like(order)
    inv[order] = torch.arange(t * k, device=dev)
    slot, keep = slot_s[inv], keep_s[inv]
    w = (gates.reshape(-1) * keep.float()).to(cdt)
    contrib = y[slot.clamp(max=e * cap - 1)] * w[:, None]            # [T·k, D] in cdt
    return contrib.reshape(t, k, d).float().sum(dim=1).to(cdt)


def moe(params, x: torch.Tensor, cfg, *, mesh=None) -> torch.Tensor:
    """x [B, S, D] → [B, S, D], every expert on this device (``mesh`` None or
    one model shard), plus the shared experts where the config has them."""
    if cfg.moe_weight_stationary:
        raise NotImplementedError(f"moe_weight_stationary serving {EP_NOT_PORTED}")
    if mesh is not None and mesh.n_model > 1:
        raise NotImplementedError(
            f"expert parallelism over {mesh.n_model} model shards {EP_NOT_PORTED}")
    b, s, d = x.shape
    out = _moe_local(x.reshape(b * s, d), params["router"], params["wg"], params["wu"],
                     params["wd"], cfg).reshape(b, s, d)
    if cfg.n_shared_experts:
        cdt = torch_dtype(cfg.compute_dtype)
        g = x @ params["shared_wg"].to(cdt)
        u = x @ params["shared_wu"].to(cdt)
        out = out + (_act(g, cfg.activation) * u) @ params["shared_wd"].to(cdt)
    return out
