"""Mixture-of-Experts layer: sort-based capacity dispatch, expert parallel.

The port of ``repro.models.moe``.  The local path (``_moe_local``): router
logits → top-k → flatten the (token, expert) pairs, stable-sort them by
expert, rank each pair within its expert, drop pairs past the per-expert
capacity, gather the kept tokens into an ``[E_loc, C, D]`` buffer, two
batched products and the down projection, and combine each token's k
expert outputs weighted by its gates.

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

Under a mesh, JAX's selection (``moe.py:220-231``):

* ``moe_weight_stationary`` with a model group > 1 that divides the experts
  and a ``data`` axis that divides D: :func:`_moe_weight_stationary`, the
  serving island whose in-specs match the experts' (model × data) storage:
  tokens are all-gathered over the data axes, each rank dispatches its
  D-slice, ``g``/``u`` are summed over ``data``, the combine over
  ``model``, and the D-slices are gathered back;
* otherwise with a model group > 1 that divides the experts: the
  expert-parallel island, experts over ``model`` (``E_loc = E / tp``, the
  first at ``axis_index(model)·E_loc``), tokens sharded over the data axes,
  one ``psum`` over ``model``;
* otherwise the local path on the global tokens, in an island where every
  rank holds them all (the sort and ``searchsorted`` have no DTensor rule).

The routing is computed on the same tokens as JAX's in each island, so the
capacity and the drops are JAX's.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.distributed.api import (BATCH_AXES, FSDP_AXIS, TP_AXIS, P, active_mesh,
                                        all_gather, axis_index, axis_size, fit_entry, psum,
                                        shard_map)

from .config import torch_dtype
from .layers import ParamDef
from .mlp import _act


def moe_defs(cfg) -> Dict[str, ParamDef]:
    d, e, fe = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    dt = cfg.param_dtype
    defs = {
        "router": ParamDef((d, e), (FSDP_AXIS, None), "fan_in", dt),
        "wg": ParamDef((e, d, fe), (TP_AXIS, FSDP_AXIS, None), "fan_in", dt, keep_fsdp=True),
        "wu": ParamDef((e, d, fe), (TP_AXIS, FSDP_AXIS, None), "fan_in", dt, keep_fsdp=True),
        "wd": ParamDef((e, fe, d), (TP_AXIS, None, FSDP_AXIS), "fan_in", dt, keep_fsdp=True),
    }
    if cfg.n_shared_experts:
        fe_sh = cfg.moe_d_ff * cfg.n_shared_experts
        defs["shared_wg"] = ParamDef((d, fe_sh), (FSDP_AXIS, TP_AXIS), "fan_in", dt)
        defs["shared_wu"] = ParamDef((d, fe_sh), (FSDP_AXIS, TP_AXIS), "fan_in", dt)
        defs["shared_wd"] = ParamDef((fe_sh, d), (TP_AXIS, FSDP_AXIS), "fan_in", dt)
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


def plan(x2d: torch.Tensor, router: torch.Tensor, cfg, cap: int, e0: int, e_loc: int):
    """Route the tokens and place each (token, expert) pair: returns (gates
    [T, k], the pairs' expert-sorted order [T·k], their buffer slot and
    whether each is kept, in that order).  A pair is kept when its rank in
    its expert is below ``cap`` and its expert is one of the local
    ``[e0, e0 + e_loc)``; a dropped pair's slot is the spare row
    ``e_loc·cap``."""
    t = x2d.shape[0]
    gates, eids = route(x2d, router, cfg)
    flat_e = eids.reshape(-1)                                        # [T·k], token-major
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    rank = torch.arange(t * cfg.top_k, device=x2d.device) - torch.searchsorted(se, se,
                                                                             side="left")
    keep_s = (rank < cap) & (se >= e0) & (se < e0 + e_loc)
    slot_s = torch.where(keep_s, (se - e0) * cap + rank, torch.full_like(se, e_loc * cap))
    return gates, order, slot_s, keep_s


def _dispatch(x2d, order, slot_s, k: int, rows: int, cdt) -> torch.Tensor:
    """The kept tokens gathered into a [rows, D] buffer; dropped pairs land
    on the spare last row, cut off."""
    buf = torch.zeros((rows + 1, x2d.shape[1]), dtype=cdt, device=x2d.device)
    return buf.index_put((slot_s,), x2d[order // k].to(cdt))[:-1]


def _combine(y, gates, order, slot_s, keep_s, t: int, k: int, cdt) -> torch.Tensor:
    """Each token's k expert outputs y [rows, D] weighted by its gates,
    summed over k in f32 in index order; a dropped pair's weight is 0."""
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.numel(), device=order.device)
    slot, keep = slot_s[inv], keep_s[inv]
    w = (gates.reshape(-1) * keep.float()).to(cdt)
    contrib = y[slot.clamp(max=y.shape[0] - 1)] * w[:, None]          # [T·k, D] in cdt
    return contrib.reshape(t, k, -1).float().sum(dim=1).to(cdt)


def _moe_local(x2d, router, wg, wu, wd, cfg, e0: int = 0):
    """Tokens [T, D] × the local experts' wg/wu/wd [E_loc, ...] (the first
    is expert ``e0``) → [T, D], those experts' part of the output."""
    t, d = x2d.shape
    k = cfg.top_k
    e_loc = wg.shape[0]
    cdt = torch_dtype(cfg.compute_dtype)
    cap = capacity(t, cfg)
    gates, order, slot_s, keep_s = plan(x2d, router, cfg, cap, e0, e_loc)
    buf = _dispatch(x2d, order, slot_s, k, e_loc * cap, cdt).reshape(e_loc, cap, d)
    h = _act(torch.bmm(buf, wg.to(cdt)), cfg.activation) * torch.bmm(buf, wu.to(cdt))
    y = torch.bmm(h, wd.to(cdt)).reshape(e_loc * cap, d)
    return _combine(y, gates, order, slot_s, keep_s, t, k, cdt)


def _moe_weight_stationary(params, x, cfg, mesh, tp: int):
    """Serving: the experts keep their 2-D (model × data) storage, and the
    *tokens* move (all-gathered over the data axes: a few MB at decode
    batch sizes, against every expert's weights each layer).  Capacity is
    ``t_g`` up to 32 gathered tokens (drop-free), else capacity-factor
    dropping."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    e_loc = e // tp
    cdt = torch_dtype(cfg.compute_dtype)
    entry = fit_entry(BATCH_AXES, b, mesh)
    daxes = () if entry is None else ((entry,) if isinstance(entry, str) else tuple(entry))
    nd_fsdp = mesh.shape.get("data", 1)
    d_slice = d // nd_fsdp

    def island(x_loc, router, wg_loc, wu_loc, wd_loc):
        bl, sl, _ = x_loc.shape
        x_g = all_gather(x_loc, daxes, axis=0) if daxes else x_loc    # [b_g, s, d]
        t_g = x_g.shape[0] * sl
        x2 = x_g.reshape(t_g, d)
        cap = t_g if t_g <= 32 else max(k, int(t_g * k / e * cfg.capacity_factor))
        gates, order, slot_s, keep_s = plan(x2, router, cfg, cap, axis_index(TP_AXIS) * e_loc,
                                            e_loc)
        # dispatch only the local D-slice of each token (the weights stay put)
        d0 = axis_index("data") * d_slice if nd_fsdp > 1 else 0
        buf = _dispatch(x2[:, d0:d0 + d_slice], order, slot_s, k, e_loc * cap, cdt)
        buf = buf.reshape(e_loc, cap, d_slice)
        g_part = torch.bmm(buf, wg_loc.to(cdt))
        u_part = torch.bmm(buf, wu_loc.to(cdt))
        if nd_fsdp > 1:                                                # combine the D slices
            g_part, u_part = psum(g_part, "data"), psum(u_part, "data")
        h = _act(g_part, cfg.activation) * u_part                      # [E_loc, cap, Fe]
        y = torch.bmm(h, wd_loc.to(cdt)).reshape(e_loc * cap, d_slice)
        out_sl = psum(_combine(y, gates, order, slot_s, keep_s, t_g, k, cdt), TP_AXIS)
        out = all_gather(out_sl, "data", axis=1) if nd_fsdp > 1 else out_sl   # [t_g, d]
        if not daxes:
            return out.reshape(bl, sl, d)
        idx = 0                                                        # this shard's rows
        for a in daxes:
            idx = idx * mesh.shape[a] + axis_index(a)
        return out[idx * bl * sl:(idx + 1) * bl * sl].reshape(bl, sl, d)

    fsdp_d = "data" if nd_fsdp > 1 else None
    return shard_map(
        island, mesh=mesh,
        in_specs=(P(entry, None, None), P(None, None), P(TP_AXIS, fsdp_d, None),
                  P(TP_AXIS, fsdp_d, None), P(TP_AXIS, None, fsdp_d)),
        out_specs=P(entry, None, None),
    )(x, params["router"], params["wg"], params["wu"], params["wd"])


def moe(params, x: torch.Tensor, cfg) -> torch.Tensor:
    """x [B, S, D] → [B, S, D]; experts sharded over the ``model`` mesh
    axis under a mesh; plus the shared experts where the config has them."""
    b, s, d = x.shape
    mesh = active_mesh()
    tp = axis_size(TP_AXIS)
    e = cfg.n_experts
    if (cfg.moe_weight_stationary and mesh is not None and tp > 1 and e % tp == 0
            and d % max(1, mesh.shape.get("data", 1)) == 0):
        out = _moe_weight_stationary(params, x, cfg, mesh, tp)
    elif mesh is None:
        out = _moe_local(x.reshape(b * s, d), params["router"], params["wg"], params["wu"],
                         params["wd"], cfg).reshape(b, s, d)
    elif tp == 1 or e % tp != 0:
        # the local path on the global tokens: every rank holds them all
        def local(x, router, wg, wu, wd):
            return _moe_local(x.reshape(b * s, d), router, wg, wu, wd, cfg).reshape(b, s, d)
        rep = (P(None, None, None), P(None, None)) + (P(None, None, None),) * 3
        out = shard_map(local, mesh=mesh, in_specs=rep, out_specs=P(None, None, None))(
            x, params["router"], params["wg"], params["wu"], params["wd"])
    else:   # expert parallel: E/tp experts a rank, one psum over 'model'
        e_loc = e // tp
        entry = fit_entry(BATCH_AXES, b, mesh)

        def island(x_loc, router, wg_loc, wu_loc, wd_loc):
            bl, sl, _ = x_loc.shape
            part = _moe_local(x_loc.reshape(bl * sl, d), router, wg_loc, wu_loc, wd_loc, cfg,
                              axis_index(TP_AXIS) * e_loc)
            return psum(part, TP_AXIS).reshape(bl, sl, d)

        experts = P(TP_AXIS, None, None)
        out = shard_map(island, mesh=mesh,
                        in_specs=(P(entry, None, None), P(None, None), experts, experts,
                                  experts),
                        out_specs=P(entry, None, None))(
            x, params["router"], params["wg"], params["wu"], params["wd"])
    if cfg.n_shared_experts:
        cdt = torch_dtype(cfg.compute_dtype)
        g = x @ params["shared_wg"].to(cdt)
        u = x @ params["shared_wu"].to(cdt)
        out = out + (_act(g, cfg.activation) * u) @ params["shared_wd"].to(cdt)
    return out
