"""Batch reductions in a closed loop: one user, one reduction at a time.

Job ``j`` of a run reduces a fresh table ``(seed, j)`` of the configuration's
full shape, made on the device between jobs (outside the job's time) and
handed to the program as the deployment would hold it: a device-resident
int32 table.  A job runs the two calls of ``repro_torch.launch.reduce``, in
its order:

    gran = resolve_granularity(x, d, n_dec=..., v_max=...)   # GrC initialisation
    result = plar_reduce(source=gran, **config["run"])        # Θ(D|C), core, greedy loop

timed by the host clock from the hand-over to the result on the host, each
call ended by ``torch.cuda.synchronize()``.  Set-up runs ``warmup_jobs``
whole jobs on tables of their own, so that every kernel is built and loaded
and the allocator holds its pools before the window opens.

Jobs keep starting until ``seconds`` have passed; the job running at the
close completes and counts.  A second window of the same run (a traced run's
traced half) goes on from the next job number.  A sample of the jobs, drawn from the seed
(``sample_every``; job 0 always), keeps the program's granules on the host,
and after the window the reference recomputes those jobs from their tables.

Parameters: ``warmup_jobs``, ``sample_every``, ``chunk`` (the reference's
candidates a pass).
"""
from __future__ import annotations

import time
import types

import torch

from plarbench.reference.compare import answer_gaps, fold_gaps, granules_off
from plarbench.reference.plar import Reducer, granulate, reach
from plarbench.tables import derive_seed, make_table


def _sampled(ctx, j: int) -> bool:
    return j == 0 or derive_seed(ctx.seed, "sample", j) % int(ctx.params["sample_every"]) == 0


def _job(ctx, st, j, x, d, keep: bool) -> dict:
    cfg, tr = ctx.config, ctx.trace
    ctx.sync()
    t0 = tr.mark()
    with tr.phase("granulate"):
        gran = st.resolve_granularity(x, d, n_dec=int(cfg["n_dec"]),
                                      v_max=int(cfg["v_max"]), device=ctx.device)
        ctx.sync()
    t1 = time.perf_counter()
    with tr.phase("loop"):
        r = st.plar_reduce(source=gran, device=ctx.device, **cfg["run"])
        ctx.sync()
    t2 = tr.mark()
    granules = int(gran.num)
    job = {"j": j, "ok": True, "t0": t0, "t2": t2, "total_s": t2 - t0,
           "granulate_s": t1 - t0, "loop_s": t2 - t1, "granules": granules,
           "iterations": r.iterations, "n_attrs": gran.n_attrs,
           "reduct": list(r.reduct), "core": list(r.core),
           "theta_full": float(r.theta_full), "theta_history": list(r.theta_history)}
    if keep:
        job["granules_host"] = tuple(t[:granules].cpu().numpy()
                                     for t in (gran.x, gran.d, gran.w))
    return job


def setup(ctx):
    from repro_torch.core.reduction import plar_reduce, resolve_granularity
    from repro_torch.kernels.contingency import ops

    st = types.SimpleNamespace(plar_reduce=plar_reduce,
                               resolve_granularity=resolve_granularity)
    for w in range(int(ctx.params["warmup_jobs"])):
        x, d = make_table(ctx.config, ctx.seed, ("warmup", w), ctx.device)
        job = _job(ctx, st, -1 - w, x, d, keep=False)
        del x, d
        ctx.log(f"warm-up job {w}: {job['granules']} granules, {job['iterations']} "
                f"iterations, {job['total_s']} s (granulate {job['granulate_s']} s)")
    if ctx.trace.enabled:
        ctx.log(f"Θ kernel launches in set-up: {dict(ops.LAUNCHES)}")
    st.ops = ops
    st.next_j = 0
    return st


def window(ctx, st, seconds: float) -> dict:
    jobs = []
    launches_before = dict(st.ops.LAUNCHES)
    t_end = time.perf_counter() + seconds
    j = st.next_j
    while time.perf_counter() < t_end:
        with ctx.trace.phase("generate"):
            x, d = make_table(ctx.config, ctx.seed, j, ctx.device)
        try:
            jobs.append(_job(ctx, st, j, x, d, keep=_sampled(ctx, j)))
        except Exception as e:  # a failed job counts in `failed`, the loop goes on
            ctx.log(f"job {j} failed: {type(e).__name__}: {e}")
            jobs.append({"j": j, "ok": False, "error": f"{type(e).__name__}: {e}"})
        del x, d
        j += 1
    st.next_j = j
    if ctx.trace.enabled:
        ctx.log("Θ kernel launches in the window: " + str(
            {k: v - launches_before[k] for k, v in st.ops.LAUNCHES.items()}))
    ok = [job for job in jobs if job["ok"]]
    if ok:
        ctx.log(f"granules per job: {sorted({job['granules'] for job in ok})}")
        ctx.log(f"{len(ok)} jobs in {seconds} s{' (profiled)' if ctx.trace.profiling else ''}: "
                f"{sum(job['total_s'] for job in ok) / len(ok)} s a job")
    return {"jobs": jobs, "attempted": len(jobs), "failed": len(jobs) - len(ok)}


def release(ctx, st) -> None:
    st.__dict__.clear()


def check(ctx, record: dict) -> dict:
    """The reference's numbers over the sampled jobs."""
    cfg = ctx.config
    run = cfg["run"]
    rows, off, followed = [], 0, {}
    for job in record["jobs"]:
        if not job["ok"] or "granules_host" not in job:
            continue
        x, d = make_table(cfg, ctx.seed, job["j"], ctx.device)
        ref_g = granulate(x, d)
        del x, d
        off += granules_off(*job["granules_host"], ref_g)
        red = Reducer(ref_g, n_dec=int(cfg["n_dec"]), v_max=int(cfg["v_max"]),
                      delta=run["delta"], **reach(ctx.cell.theta_reach),
                      chunk=int(ctx.params["chunk"]))
        ans = red.reduce(compute_core=bool(run.get("compute_core", True)), follow=job)
        rows.append(answer_gaps(job, ans))
        followed = {k: max(v, followed.get(k, 0.0)) for k, v in red.followed.items()}
        del red, ref_g
    values = fold_gaps(rows)
    values["granules_off"] = float(off)
    values["unanswered"] = float(record["failed"])
    ctx.log(f"reference compared {len(rows)} jobs; reach its following needed: {followed} "
            f"(the cell's: {ctx.cell.theta_reach})")
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    return values
