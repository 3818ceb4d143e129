"""Row batches streamed into the reduct service, each followed by a query.

One client of ``repro_torch.service.ReductServer`` (batching on, checkpoints
off: the server's defaults), on the deployment's table ``(seed, "stream")``:

* set-up submits ``initial_fraction`` of the configuration's rows, drawn
  from the table's prototypes,
  answers a first (cold) query, and makes ``warmup_updates`` updates;
* each update pushes the next of a pool of ``pool`` batches of
  ``batch_fraction`` of the rows (drawn in set-up from the same prototypes and held on
  the host, as rows arrive from the host), then queries the reduct
  (``query``: the measure and the knobs).  The client waits for the answer
  before it sends the next batch, so every answer reflects exactly the rows
  pushed so far;
* updates are due at a fixed rate, ``rate_per_s`` (the cell's: below the
  rate the service sustains, so that an update seldom waits for the one
  before it); an update that is due while the previous one is still open is
  sent when that one's answer comes, and its latency counts from when it was
  due.  A second window of the same run (a traced run's traced half) goes
  on with the next batch and a fresh schedule.

The latency of an update runs from when it was due to the query's answer on
the host.  In a traced run the service's spans (``scheduler.merge``,
``scheduler.dispatch``) are recorded (``repro_torch.obs``), with host
times.  After the window the reference checks every answer: the
table as it has grown through each update, the cold answer, then each warm
repair from the program's previous answer (the state the repair starts
from), and the final granular table.
"""
from __future__ import annotations

import asyncio
import math
import time
import types

import torch

from plarbench.reference.compare import answer_gaps, fold_gaps, granules_off
from plarbench.reference.plar import Granules, Reducer, granulate, reach, union_granules
from plarbench.tables import draw_rows, prototypes

NAME = "stream"


def _rows(ctx, key: str) -> int:
    return int(round(int(ctx.config["rows"]) * float(ctx.params[key])))
SPANS = ("scheduler.merge", "scheduler.dispatch")


def _answer(result) -> dict:
    return {"reduct": list(result.reduct), "core": list(result.core),
            "theta_full": float(result.theta_full),
            "theta_history": list(result.theta_history)}


async def _update(ctx, st, k: int) -> dict:
    """Update ``k`` (batch ``k % pool``) and its query; the answer, or the error."""
    q = dict(ctx.params["query"])
    delta = q.pop("delta")
    batch = k % len(st.pool)
    x, d = st.pool[batch]
    try:
        await st.srv.update(NAME, x, d)
        result = await st.srv.query(NAME, delta, **q)
    except Exception as e:  # a refused or failed update counts in `failed`
        ctx.log(f"update failed: {type(e).__name__}: {e}")
        return {"ok": False, "batch": batch, "error": f"{type(e).__name__}: {e}"}
    return {"ok": True, "batch": batch, **_answer(result)}


def setup(ctx):
    from repro_torch.service import ReductServer

    cfg, p = ctx.config, ctx.params
    if not float(p["rate_per_s"]) > 0:
        raise ValueError(f"rate_per_s must be above 0, not {p['rate_per_s']!r}")
    protos = prototypes(cfg, ctx.seed, NAME, ctx.device)
    x0, d0 = draw_rows(protos, _rows(ctx, "initial_fraction"), "initial")
    pool = [tuple(t.cpu().numpy() for t in draw_rows(protos, _rows(ctx, "batch_fraction"), "pool", b))
            for b in range(int(p["pool"]))]
    del protos
    st = types.SimpleNamespace(loop=asyncio.new_event_loop(), pool=pool, answers=[],
                               reported=0)
    st.srv = ReductServer(device=ctx.device)
    st.loop.run_until_complete(st.srv.start())
    st.loop.run_until_complete(st.srv.submit(NAME, x0, d0, n_dec=int(cfg["n_dec"]),
                                             v_max=int(cfg["v_max"])))
    del x0, d0
    q = dict(p["query"])
    first = st.loop.run_until_complete(st.srv.query(NAME, q.pop("delta"), **q))
    st.answers.append({"ok": True, "batch": None, **_answer(first)})
    ctx.log(f"submitted {_rows(ctx, 'initial_fraction')} rows: "
            f"{st.srv.handle(NAME).n_granules} granules; cold answer {first.reduct}")
    for k in range(int(p["warmup_updates"])):
        t0 = time.perf_counter()
        ans = st.loop.run_until_complete(_update(ctx, st, k))
        st.answers.append(ans)
        ctx.log(f"warm-up update {k}: {time.perf_counter() - t0} s, "
                f"{st.srv.handle(NAME).n_granules} granules")
    return st


def window(ctx, st, seconds: float) -> dict:
    from repro_torch import obs

    tr = ctx.trace
    rate = float(ctx.params["rate_per_s"])
    tracer = obs.get_tracer()
    if tr.enabled:
        obs.enable()
        tracer.clear()
        t_host = time.perf_counter()
        obs.event("plarbench.clock")
        epoch = t_host - tracer.records()[-1].t_start
    else:
        obs.disable()
    updates = []

    async def client():
        t0 = time.perf_counter()
        t_end, i = t0 + seconds, 0
        while True:
            now = time.perf_counter()
            due = t0 + i / rate
            if due >= t_end:
                break
            if due > now:
                await asyncio.sleep(due - now)
            start = tr.mark()
            with tr.phase("update"):
                ans = await _update(ctx, st, len(st.answers) - 1)
            done = tr.mark()
            st.answers.append(ans)
            updates.append({"due": due, "start": start, "done": done, "ok": ans["ok"],
                            "latency_s": done - due if ans["ok"] else math.inf})
            i += 1

    st.loop.run_until_complete(client())
    spans = []
    if tr.enabled:
        spans = [(r.name, r.t_start + epoch, r.t_start + epoch + r.dur)
                 for r in tracer.records() if r.ph == "X" and r.name in SPANS]
        obs.disable()
    handle = st.srv.handle(NAME)
    gran = handle.gran
    n = int(gran.num)
    final = tuple(t[:n].cpu().numpy() for t in (gran.x, gran.d, gran.w))
    failed = sum(not u["ok"] for u in updates)
    late = [u["start"] - u["due"] for u in updates] or [0.0]
    served = sorted(u["done"] - u["start"] for u in updates) or [math.nan]
    ctx.log(f"{len(updates)} updates in {seconds} s{' (profiled)' if tr.profiling else ''}, "
            f"{n} granules at the close; served in {served[len(served) // 2]} s (median), "
            f"{served[-1]} s at most; sent late by {max(late)} s at most, "
            f"{sum(1 for x in late if x > 1e-3)} later than 1 ms")
    answers, st.reported = st.answers[st.reported:], len(st.answers)
    return {"updates": updates, "answers": answers, "spans": spans,
            "final_granules": final, "attempted": len(updates), "failed": failed}


def release(ctx, st) -> None:
    st.loop.run_until_complete(st.srv.stop())
    st.loop.close()
    st.__dict__.clear()


def check(ctx, record: dict) -> dict:
    """The reference's chain of answers and its final table."""
    cfg, p = ctx.config, ctx.params
    protos = prototypes(cfg, ctx.seed, NAME, ctx.device)
    parts = [granulate(*draw_rows(protos, _rows(ctx, "initial_fraction"), "initial"))]
    parts += [granulate(*draw_rows(protos, _rows(ctx, "batch_fraction"), "pool", b))
              for b in range(int(p["pool"]))]
    del protos
    union, weights = union_granules(parts)
    del parts
    red = Reducer(union, n_dec=int(cfg["n_dec"]), v_max=int(cfg["v_max"]),
                  delta=p["query"]["delta"], **reach(ctx.cell.theta_reach),
                  chunk=int(p["chunk"]))
    applied = torch.zeros((weights.shape[0],), dtype=torch.float64, device=weights.device)
    applied[0] = 1.0
    rows, prev = [], None
    for k, ans in enumerate(record["answers"]):
        if k:
            applied[1 + (k - 1) % int(p["pool"])] += 1.0
        if not ans["ok"]:
            break
        red.set_weights(applied @ weights)
        ref = red.repair(prev, follow=ans)
        rows.append(answer_gaps(ans, ref))
        prev = ans["reduct"]
    values = fold_gaps(rows)
    live = red.w > 0
    final = Granules(x=union.x[live], d=union.d[live], w=red.w[live])
    values["granules_off"] = float(granules_off(*record["final_granules"], final))
    values["unanswered"] = float(record["failed"])
    ctx.log(f"reference followed {len(rows)} answers; reach its following needed: "
            f"{red.followed} (the cell's: {ctx.cell.theta_reach})")
    return values
