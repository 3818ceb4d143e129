"""The paper's four heuristics in one pass: closed loop, one user, one grid of
reductions at a time.

Job ``j`` of a run reduces a fresh table ``(seed, j)`` of the configuration's
full shape, made on the device between jobs (outside the job's time) and
handed over as a device-resident int32 table, under every measure of the
mix at once.  A job runs the two calls of
``repro_torch.launch.reduce --ensemble all`` at the command's defaults:

    gran = resolve_granularity(x, d, n_dec=..., v_max=...)     # GrC initialisation
    results = plar_reduce_ensemble(source=gran,                # Θ(D|C) and the core of
        configs=[{"delta": m} for m in measures], **run)       # each; one stacked loop

timed by the host clock from the hand-over to the grid's answers on the
host, each call ended by ``torch.cuda.synchronize()``.  The configuration's
own ``run`` is not read: the grid and its shared knobs are the mix's
(``measures``, ``run``).  Set-up runs ``warmup_jobs`` whole jobs on tables
of their own, which also captures the stacked loop's CUDA graph, so nothing
is captured inside the window.

Jobs keep starting until ``seconds`` have passed; the job running at the
close completes and counts.  A sample of the jobs (``sample_every``, drawn
from the seed; job 0 always) keeps the program's granules on the host, and
after the window the reference recomputes the granules of those jobs once
and each member's Θ(D|C), core, greedy reduct and Θ history under the
member's measure.

Parameters: ``warmup_jobs``, ``sample_every``, ``chunk`` (the reference's
candidates a pass), ``measures``, ``run`` (``plar_reduce_ensemble``'s shared
knobs) and, optionally, ``reach_by_measure`` (a measure's own
``theta_reach``, where it differs from the cell's).
"""
from __future__ import annotations

import contextlib
import time
import types

import torch

from plarbench.reference.compare import answer_gaps, fold_gaps, granules_off
from plarbench.reference.plar import Reducer, granulate, reach
from plarbench.tables import make_table
from plarbench.traffic.batch import _sampled

MEMBER_KEYS = ("delta", "reduct", "core", "theta_full", "theta_history", "iterations")


def reduce_table(config: dict, params: dict, x, d, device, phase=None):
    """The job's two calls on one table, each ended by a synchronize where
    ``device`` is a card, each inside ``phase(name)`` where given:
    ``(gran, results, the host time between the two)``."""
    from repro_torch.core.reduction import plar_reduce_ensemble, resolve_granularity

    dev = torch.device(device)
    phase = phase or (lambda name: contextlib.nullcontext())

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    with phase("granulate"):
        gran = resolve_granularity(x, d, n_dec=int(config["n_dec"]),
                                   v_max=int(config["v_max"]), device=dev)
        sync()
    t1 = time.perf_counter()
    with phase("loop"):
        results = plar_reduce_ensemble(source=gran, device=dev, **params["run"],
                                       configs=[{"delta": m} for m in params["measures"]])
        sync()
    return gran, results, t1


def _job(ctx, j, x, d, keep: bool) -> dict:
    tr = ctx.trace
    ctx.sync()
    t0 = tr.mark()
    gran, results, t1 = reduce_table(ctx.config, ctx.params, x, d, ctx.device, tr.phase)
    t2 = tr.mark()
    granules = int(gran.num)
    members = [dict(zip(MEMBER_KEYS, (m, list(r.reduct), list(r.core), float(r.theta_full),
                                      list(r.theta_history), r.iterations)))
               for m, r in zip(ctx.params["measures"], results)]
    job = {"j": j, "ok": True, "t0": t0, "t2": t2, "total_s": t2 - t0,
           "granulate_s": t1 - t0, "loop_s": t2 - t1, "granules": granules,
           "n_attrs": gran.n_attrs, "members": members}
    if keep:
        job["granules_host"] = tuple(t[:granules].cpu().numpy()
                                     for t in (gran.x, gran.d, gran.w))
    return job


def setup(ctx):
    st = types.SimpleNamespace()
    for w in range(int(ctx.params["warmup_jobs"])):
        x, d = make_table(ctx.config, ctx.seed, ("warmup", w), ctx.device)
        job = _job(ctx, -1 - w, x, d, keep=False)
        del x, d
        ctx.log(f"warm-up job {w}: {job['granules']} granules, "
                f"{[(m['delta'], len(m['core']), m['iterations']) for m in job['members']]} "
                f"(measure, core, iterations), {job['total_s']} s "
                f"(granulate {job['granulate_s']} s)")
    st.next_j = 0
    return st


def window(ctx, st, seconds: float) -> dict:
    jobs = []
    t_end = time.perf_counter() + seconds
    j = st.next_j
    while time.perf_counter() < t_end:
        with ctx.trace.phase("generate"):
            x, d = make_table(ctx.config, ctx.seed, j, ctx.device)
        try:
            jobs.append(_job(ctx, j, x, d, keep=_sampled(ctx, j)))
        except Exception as e:  # a failed job counts in `failed`, the loop goes on
            ctx.log(f"job {j} failed: {type(e).__name__}: {e}")
            jobs.append({"j": j, "ok": False, "error": f"{type(e).__name__}: {e}"})
        del x, d
        j += 1
    st.next_j = j
    ok = [job for job in jobs if job["ok"]]
    if ok:
        ctx.log(f"granules per job: {sorted({job['granules'] for job in ok})}")
        ctx.log(f"{len(ok)} jobs in {seconds} s{' (profiled)' if ctx.trace.profiling else ''}: "
                f"{sum(job['total_s'] for job in ok) / len(ok)} s a job")
    return {"jobs": jobs, "attempted": len(jobs), "failed": len(jobs) - len(ok)}


def release(ctx, st) -> None:
    st.__dict__.clear()


def member_reach(cell, delta: str) -> dict:
    """The ``theta_reach`` the reference follows a member's answer within."""
    return cell.params.get("reach_by_measure", {}).get(delta, cell.theta_reach)


def check(ctx, record: dict) -> dict:
    """The reference's numbers over the sampled jobs: ``granules_off`` a
    job; ``core_off`` and ``reduct_off`` summed over the members (and the
    two of one measure's members, ``<measure>_off``, for tools that ask);
    ``theta_gap_<measure>`` the widest gap of that measure's members."""
    cfg = ctx.config
    rows, off, followed = [], 0, {}
    for job in record["jobs"]:
        if not job["ok"] or "granules_host" not in job:
            continue
        x, d = make_table(cfg, ctx.seed, job["j"], ctx.device)
        ref_g = granulate(x, d)
        del x, d
        off += granules_off(*job["granules_host"], ref_g)
        for member in job["members"]:
            delta = member["delta"]
            red = Reducer(ref_g, n_dec=int(cfg["n_dec"]), v_max=int(cfg["v_max"]), delta=delta,
                          chunk=int(ctx.params["chunk"]), **reach(member_reach(ctx.cell, delta)))
            gaps = answer_gaps(member, red.reduce(compute_core=True, follow=member))
            gaps[f"theta_gap_{delta}"] = gaps.pop("theta_gap")
            gaps[f"{delta}_off"] = gaps["reduct_off"] + gaps["core_off"]
            rows.append(gaps)
            followed[delta] = {k: max(v, followed.get(delta, {}).get(k, 0.0))
                               for k, v in red.followed.items()}
            del red
        del ref_g
    values = fold_gaps(rows)
    values["granules_off"] = float(off)
    values["unanswered"] = float(record["failed"])
    ctx.log(f"reference compared {len(rows)} answers; reach its following needed: {followed} "
            f"(the cell's: {ctx.cell.theta_reach}, by measure: "
            f"{ctx.params.get('reach_by_measure', {})})")
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    return values
