"""The mesh driver's schedules and layouts at a cell's size: seconds a job,
collective bytes a job and the reduct, for each collective schedule on each
mesh, on the cards of one host.

    python3 plarbench/tools/mesh_sweep.py --workload kdd99.mesh4 --seed 7 \\
        --collectives all_reduce reduce_scatter fused --meshes 4,1 2,2 --jobs 3
    python3 plarbench/tools/mesh_sweep.py --seed 7 --device cpu --rows 20000   # rehearsal

Each (mesh, schedule) runs in a world of its own (one NCCL rank a card, as
``traffic/mesh.py`` and ``launch/reduce.py --distributed`` start them).
Every rank makes each job's table ``(seed, job)`` of the cell's
configuration on its card and keeps its data shard's rows, and the job is
``plar_reduce_distributed(partition=True)`` between two barriers, timed on
rank 0's host clock.  The first job warms the world up and is not timed.
Prints one JSON line a (mesh, schedule): the median seconds of the timed
jobs, their collective bytes (``plar_mesh_collective_bytes_total`` on rank
0) and each job's reduct, and last a line saying whether every
(mesh, schedule) gave the same reduct and core on every job.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def _rank(device, cfg: dict, seed: int, mesh_shape, run: dict, jobs: int, out: str) -> None:
    import torch
    import torch.distributed as dist

    from plarbench.traffic.mesh import _answer, _barrier, _shard_table
    from repro_torch.core.distributed import plar_reduce_distributed
    from repro_torch.core.engine import _MeshColl
    from repro_torch.distributed import make_mesh

    mesh = make_mesh(mesh_shape, ("data", "model"), device=device)
    counter = _MeshColl.bytes_counter()
    rows = []
    for j in range(jobs):
        x, d = _shard_table(cfg, seed, j, device, mesh.data_index, mesh.n_data)
        _barrier(device)
        b0, t0 = counter.value, time.perf_counter()
        r = plar_reduce_distributed(x, d, mesh, partition=True, **run)
        _barrier(device)
        rows.append({"job": j, "seconds": time.perf_counter() - t0,
                     "collective_bytes": counter.value - b0, **_answer(r)})
        del x, d, r
    rows[-1]["peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                              if device.type == "cuda" else None)
    if dist.get_rank() == 0:
        with open(out, "w") as f:
            json.dump(rows, f)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python3 plarbench/tools/mesh_sweep.py")
    ap.add_argument("--workload", default="kdd99.mesh4")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--collectives", nargs="+", default=["all_reduce", "reduce_scatter", "fused"])
    ap.add_argument("--meshes", nargs="+", default=["4,1", "2,2"])
    ap.add_argument("--jobs", type=int, default=3)
    ap.add_argument("--device", default="cuda", help="cuda, or cpu (gloo) to rehearse")
    ap.add_argument("--rows", type=int, help="the table's rows (default: the cell's)")
    args = ap.parse_args(argv)

    from plarbench.harness import find_cell
    from repro_torch.distributed import spawn
    from repro_torch.kernels import build

    cell = find_cell(ROOT, args.workload)
    cfg = {**cell.config, "rows": args.rows or cell.config["rows"]}
    if args.device == "cuda":
        build.build_all(names=["fused_theta"])  # the fused schedule's kernel, built once
    answers = {}
    for text in args.meshes:
        shape = [int(v) for v in text.split(",")]
        for coll in args.collectives:
            run = {k: v for k, v in cell.config["run"].items() if k != "mesh"}
            run["collective"] = coll
            with tempfile.TemporaryDirectory() as tmp:
                out = os.path.join(tmp, "rank0.json")
                t0 = time.perf_counter()
                spawn(_rank, shape[0] * shape[1],
                      (cfg, args.seed, shape, run, args.jobs, out), device=args.device)
                with open(out) as f:
                    rows = json.load(f)
            timed = rows[1:] or rows
            answers[(text, coll)] = [(r["reduct"], r["core"]) for r in rows]
            print(json.dumps({
                "mesh": text, "collective": coll, "world_s": time.perf_counter() - t0,
                "seconds_median": statistics.median(r["seconds"] for r in timed),
                "seconds": [r["seconds"] for r in rows],
                "collective_bytes": [r["collective_bytes"] for r in rows],
                "iterations": [r["iterations"] for r in rows],
                "peak_bytes_rank0": rows[-1]["peak_bytes"],
                "reducts": [r["reduct"] for r in rows]}), flush=True)
    first = next(iter(answers.values()))
    print(json.dumps({"same_reduct_and_core": all(a == first for a in answers.values())}))


if __name__ == "__main__":
    main()
