"""The paper's cluster layout: one table in row partitions over the cards of
a host, reduced by the mesh driver, in a closed loop: one user, one
reduction at a time.

The configuration's ``run`` names the mesh (``mesh``: data, model sizes),
and this run takes one rank a mesh position: rank 0 in the harness's own
process, ranks 1..n-1 spawned by :func:`setup` (NCCL on the cards, one card
a rank; gloo on the CPU).  Job ``j`` reduces a fresh table ``(seed, j)`` of
the configuration's full shape.  Outside the job's time every rank makes
that table on its own card (``make_table``), keeps the rows of its data
shard, ``[s·N/n_data, (s+1)·N/n_data)``, and frees the rest, so a rank holds
only its partition, on its card, as a deployment caches it.  A job is then

    barrier                                                    # the hand-over
    r = plar_reduce_distributed(x_part, d_part, mesh, partition=True, **run)

on every rank, timed by rank 0's host clock from the hand-over to the
result on rank 0's host after every rank has synchronized (a second
barrier).  Every rank must return the same reduct, core and Θ history; a
job whose ranks differ counts as failed.  The record has the batch
driver's job format (``t0``, ``t2``, ``total_s``, ``reduct``, ``core``,
``theta_full``, ``theta_history``), the job's ``collective_bytes``
(``plar_mesh_collective_bytes_total`` on rank 0) and, for the window,
every rank's allocator peak (``rank_peaks_bytes``).  Set-up runs
``warmup_jobs`` whole jobs on tables of their own.

A sample of the jobs (``sample_every``, drawn from the seed; job 0 always)
keeps every rank's granules on rank 0's host, and after the window the
plain reference recomputes those jobs from the whole table on rank 0's card
(the batch driver's ``check``).

Fail fast: the process group's set-up and every collective wait time out
after ``timeout_s``; rank 0 ends its process (exit code 3) as soon as a
rank it spawned exits before the run is released, and every spawned rank
ends itself when rank 0's process is gone.

Parameters: ``warmup_jobs``, ``sample_every``, ``chunk`` (the reference's
candidates a pass), ``timeout_s``.
"""
from __future__ import annotations

import contextlib
import importlib
import multiprocessing
import os
import shutil
import sys
import tempfile
import threading
import time
import traceback
import types

import numpy as np
import torch

from plarbench.tables import make_table
from plarbench.traffic.batch import _sampled
from plarbench.traffic.batch import check as batch_check

def _shard_table(cfg: dict, seed: int, job, device, index: int, n_data: int):
    """Rows ``[index·N/n_data, (index+1)·N/n_data)`` of table ``(seed, job)``,
    made on ``device``; the rest is freed before this returns."""
    x, d = make_table(cfg, seed, job, device)
    n = x.shape[0]
    lo, hi = index * n // n_data, (index + 1) * n // n_data
    part = x[lo:hi].clone(), d[lo:hi].clone()
    del x, d
    return part


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _barrier(device) -> None:
    """Every rank here, and this rank's device idle: a one-element all-reduce
    on the world, then a synchronize."""
    import torch.distributed as dist

    t = torch.ones((1,), device=device)
    dist.all_reduce(t)
    _sync(device)


def _peak(device):
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None


def _reset_peak(device) -> None:
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def _reduce(st, x, d):
    """One job's reduction on this rank: the barrier, the call, the second
    barrier.  Returns the call's result."""
    from repro_torch.core.distributed import plar_reduce_distributed

    _barrier(st.device)
    r = plar_reduce_distributed(x, d, st.mesh, partition=True, **st.run)
    _barrier(st.device)
    return r


def _answer(r) -> dict:
    return {"reduct": list(r.reduct), "core": list(r.core),
            "theta_full": float(r.theta_full), "theta_history": list(r.theta_history),
            "iterations": int(r.iterations)}


def _live_granules(r):
    g = r.granules
    live = g.valid
    return tuple(t[live].cpu().numpy() for t in (g.x, g.d, g.w))


def _world(cfg: dict):
    mesh = [int(v) for v in cfg["run"]["mesh"]]
    run = {k: v for k, v in cfg["run"].items() if k != "mesh"}
    return mesh, run


# ---------------------------------------------------------------------------
# ranks 1..n-1
# ---------------------------------------------------------------------------


def _exit_with_parent() -> None:
    """End this process as soon as the process that spawned it is gone."""
    from multiprocessing.connection import wait

    parent = multiprocessing.parent_process()
    if parent is None:
        return

    def watch():
        wait([parent.sentinel])
        os._exit(4)
    threading.Thread(target=watch, daemon=True, name="plarbench-mesh-parent").start()


def _worker(rank: int, world: int, device_type: str, store: str, timeout_s: float, conn,
            cfg: dict, seed: int, spans: bool) -> None:
    """Rank ``rank``: serve rank 0's commands until ``stop``, or end.  An
    error ends the process at once (exit code 1, after its traceback): an
    interpreter's teardown with a process group still up could outlast rank
    0, and a spawned rank holds the run's standard output and error."""
    _exit_with_parent()
    try:
        _serve(rank, world, device_type, store, timeout_s, conn, cfg, seed, spans)
    except BaseException:
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)


def _serve(rank: int, world: int, device_type: str, store: str, timeout_s: float, conn,
           cfg: dict, seed: int, spans: bool) -> None:
    if device_type == "cpu":
        torch.set_num_threads(1)
    from repro_torch import obs
    from repro_torch.distributed.api import init_process_group, make_mesh

    if spans:
        obs.enable()
    dev = init_process_group(device_type, rank=rank, world_size=world, store_path=store,
                             timeout_s=timeout_s)
    mesh_shape, run = _world(cfg)
    mesh = make_mesh(mesh_shape, ("data", "model"), device=dev)
    st = types.SimpleNamespace(device=dev, mesh=mesh, run=run)
    conn.send(("ready", None))
    while True:
        try:
            cmd, arg = conn.recv()
        except EOFError:
            os._exit(4)
        if cmd == "job":
            label, keep = arg
            x, d = _shard_table(cfg, seed, label, dev, mesh.data_index, mesh.n_data)
            _sync(dev)
            r = _reduce(st, x, d)
            del x, d
            conn.send(("done", {**_answer(r), "granules": _live_granules(r) if keep else None}))
            del r
        elif cmd == "reset_peak":
            _reset_peak(dev)
            conn.send(("ok", None))
        elif cmd == "peak":
            conn.send(("peak", _peak(dev)))
        elif cmd == "stop":
            break
    import torch.distributed as dist

    dist.destroy_process_group()        # with rank 0's, at once (release)
    os._exit(0)


# ---------------------------------------------------------------------------
# rank 0: the harness's process
# ---------------------------------------------------------------------------


def _recv(st, r: int, want: str):
    """Rank ``r``'s next reply, which must be ``want``, within the timeout."""
    conn = st.conns[r - 1]
    if not conn.poll(st.timeout_s):
        raise TimeoutError(f"rank {r} sent nothing in {st.timeout_s} s (waiting for {want!r})")
    kind, arg = conn.recv()
    if kind != want:
        raise RuntimeError(f"rank {r} sent {kind!r}, not {want!r}: {arg}")
    return arg


def _tell(st, cmd: str, reply: str) -> list:
    """Send ``cmd`` to every spawned rank; their replies ``reply``, by rank."""
    for conn in st.conns:
        conn.send((cmd, None))
    return [_recv(st, r, reply) for r in range(1, st.world)]


def _watch(st, log) -> None:
    """Rank 0's watchdog: a spawned rank that exits before the run is
    released ends the other ranks and this process, wherever its main
    thread waits."""
    def watch():
        while not st.closing.wait(0.2):
            gone = [(r + 1, p.exitcode) for r, p in enumerate(st.procs) if p.exitcode is not None]
            if gone and not st.closing.is_set():
                log(f"refused: mesh rank {gone[0][0]} exited (code {gone[0][1]}) mid-run")
                for proc in st.procs:
                    proc.kill()
                sys.stderr.flush()
                os._exit(3)
    threading.Thread(target=watch, daemon=True, name="plarbench-mesh-watch").start()


@contextlib.contextmanager
def _fatal(ctx, st):
    """Any error on rank 0 while the world is up ends the process (exit code
    3) after stopping the spawned ranks: a rank left inside a collective
    would otherwise hold the run until its timeout."""
    try:
        yield
    except BaseException:
        ctx.log("refused: the mesh run failed on rank 0:\n" + traceback.format_exc())
        st.closing.set()
        for proc in st.procs:
            proc.kill()
        sys.stderr.flush()
        os._exit(3)


def _job(ctx, st, j, label, keep: bool) -> dict:
    cfg, tr = ctx.config, ctx.trace
    with tr.phase("generate"):
        for conn in st.conns:
            conn.send(("job", (label, keep)))
        x, d = _shard_table(cfg, ctx.seed, label, st.device, st.mesh.data_index,
                            st.mesh.n_data)
        _sync(st.device)
    counter = st.bytes_counter()
    bytes0 = counter.value
    t0 = tr.mark()
    with tr.phase("reduce"):
        r = _reduce(st, x, d)
    t2 = tr.mark()
    del x, d
    answers = [_recv(st, rank, "done") for rank in range(1, st.world)]
    mine = _answer(r)
    job = {"j": j, "ok": True, "t0": t0, "t2": t2, "total_s": t2 - t0,
           "collective_bytes": counter.value - bytes0,
           "granules": int(r.granules.valid.sum()), "n_attrs": int(r.granules.n_attrs),
           **mine}
    off = [rank for rank, a in enumerate(answers, 1) if {k: a[k] for k in mine} != mine]
    if off:
        job.update(ok=False, error=f"ranks {off} answered otherwise than rank 0")
    if keep:
        parts = [_live_granules(r)] + [a["granules"] for a in answers]
        job["granules_host"] = tuple(np.concatenate(cols) for cols in zip(*parts))
    return job


def setup(ctx):
    cfg, p = ctx.config, ctx.params
    mesh_shape, run = _world(cfg)
    world = int(np.prod(mesh_shape))
    dev_type = ctx.device.type
    if dev_type == "cuda" and torch.cuda.device_count() < world:
        raise RuntimeError(f"mesh {mesh_shape} needs {world} cards; "
                           f"{torch.cuda.device_count()} visible")
    from repro_torch import obs
    from repro_torch.core.engine import _MeshColl
    from repro_torch.distributed.api import init_process_group, make_mesh

    timeout_s = float(p["timeout_s"])
    tmp = tempfile.mkdtemp(prefix="plarbench_mesh_")
    store = os.path.join(tmp, "store")
    mp = multiprocessing.get_context("spawn")
    target = importlib.import_module("plarbench.traffic.mesh")._worker
    st = types.SimpleNamespace(world=world, timeout_s=timeout_s, tmp=tmp, conns=[], procs=[],
                               closing=threading.Event(), run=run,
                               bytes_counter=_MeshColl.bytes_counter, next_j=0)
    spans = obs.get_tracer().enabled
    with _fatal(ctx, st):
        for r in range(1, world):
            mine, theirs = mp.Pipe()
            proc = mp.Process(target=target, daemon=True, name=f"plarbench-mesh-rank{r}",
                              args=(r, world, dev_type, store, timeout_s, theirs, cfg,
                                    ctx.seed, spans))
            proc.start()
            theirs.close()
            st.conns.append(mine)
            st.procs.append(proc)
        _watch(st, ctx.log)
        st.device = init_process_group(dev_type, rank=0, world_size=world, store_path=store,
                                       timeout_s=timeout_s)
        st.mesh = make_mesh(mesh_shape, ("data", "model"), device=st.device)
        for r in range(1, world):
            _recv(st, r, "ready")
        ctx.log(f"mesh {mesh_shape}: {world} ranks on {dev_type} ({run})")
        for w in range(int(p["warmup_jobs"])):
            job = _job(ctx, st, -1 - w, ("warmup", w), keep=False)
            if not job["ok"]:
                raise RuntimeError(f"warm-up job {w}: {job['error']}")
            ctx.log(f"warm-up job {w}: {job['granules']} granules over the shards, "
                    f"{len(job['core'])} core, {job['iterations']} iterations, "
                    f"{job['total_s']} s, {job['collective_bytes']} collective bytes")
        _tell(st, "reset_peak", reply="ok")
    return st


def window(ctx, st, seconds: float) -> dict:
    jobs = []
    t_end = time.perf_counter() + seconds
    j = st.next_j
    with _fatal(ctx, st):
        while time.perf_counter() < t_end:
            jobs.append(_job(ctx, st, j, j, keep=_sampled(ctx, j)))
            if not jobs[-1]["ok"]:
                ctx.log(f"job {j} failed: {jobs[-1]['error']}")
            j += 1
        peaks = [_peak(st.device)] + _tell(st, "peak", reply="peak")
    st.next_j = j
    ok = [job for job in jobs if job["ok"]]
    if ok:
        ctx.log(f"granules per job (over the shards): {sorted({job['granules'] for job in ok})}")
        ctx.log(f"{len(ok)} jobs in {seconds} s{' (profiled)' if ctx.trace.profiling else ''}: "
                f"{sum(job['total_s'] for job in ok) / len(ok)} s a job; window peaks "
                f"by rank {peaks} B")
    return {"jobs": jobs, "attempted": len(jobs), "failed": len(jobs) - len(ok),
            "rank_peaks_bytes": peaks}


def release(ctx, st) -> None:
    """Stop the spawned ranks: every rank tears its process group down at
    once, and a rank still alive 10 s later is killed."""
    import torch.distributed as dist

    st.closing.set()
    for conn, proc in zip(st.conns, st.procs):
        if proc.is_alive():
            try:
                conn.send(("stop", None))
            except OSError:
                pass
    if dist.is_initialized():
        dist.destroy_process_group()
    for proc in st.procs:
        proc.join(10.0)
        if proc.is_alive():
            proc.kill()
            proc.join()
    shutil.rmtree(st.tmp, ignore_errors=True)
    st.__dict__.clear()


def check(ctx, record: dict) -> dict:
    """The reference's numbers over the sampled jobs, from each job's whole
    table on rank 0's card: the batch driver's check (the granules of all
    the ranks, concatenated, are the program's granular table; a granule
    held on several shards counts once with its weights summed)."""
    return batch_check(ctx, record)
