"""The control of ``correct``: the plain reference put in the program's
place, computed in bfloat16 (the precision below the configuration's
float32), and held against the float64 reference exactly as a run holds the
program: same tables, same numbers, same limits.  It has to come out not
correct.

    python3 plarbench/tools/control.py --workload kdd99.batch --seeds 1 2 3 --jobs 4
    python3 plarbench/tools/control.py --workload kdd99.stream --seeds 1 2 3 --updates 200

Batch cells: the jobs ``0..jobs-1`` of each seed (a run samples jobs among
these).  Stream cells: the cold answer and ``updates`` updates of each seed,
as many as a run's window holds.  Prints one JSON line a seed.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def control_numbers(cell, seed: int, *, jobs: int, updates: int, device) -> dict:
    """The numbers a run would compare, with the control as the program."""
    import torch

    from plarbench.reference.compare import answer_gaps, fold_gaps, make_checks
    from plarbench.reference.plar import Reducer, granulate, reach, union_granules
    from plarbench.tables import draw_rows, make_table, prototypes

    cfg, p = cell.config, cell.params

    def reducer(g, delta, dtype):
        return Reducer(g, n_dec=int(cfg["n_dec"]), v_max=int(cfg["v_max"]), delta=delta,
                       chunk=int(p["chunk"]), dtype=dtype, **reach(cell.theta_reach))

    def as_prog(a):
        return {"reduct": a.reduct, "core": a.core, "theta_full": a.theta_full,
                "theta_history": a.theta_history}

    rows = []
    if cell.traffic["driver"] == "batch":
        run = cfg["run"]
        core = bool(run.get("compute_core", True))
        for j in range(jobs):
            g = granulate(*make_table(cfg, seed, j, device))
            ctl = reducer(g, run["delta"], torch.bfloat16).reduce(compute_core=core)
            ref = reducer(g, run["delta"], torch.float64).reduce(compute_core=core,
                                                                 follow=as_prog(ctl))
            rows.append(answer_gaps(as_prog(ctl), ref))
    else:
        protos = prototypes(cfg, seed, "stream", device)
        n = int(cfg["rows"])
        parts = [granulate(*draw_rows(protos, round(n * p["initial_fraction"]), "initial"))]
        parts += [granulate(*draw_rows(protos, round(n * p["batch_fraction"]), "pool", b))
                  for b in range(int(p["pool"]))]
        union, weights = union_granules(parts)
        delta = p["query"]["delta"]
        ctl_r, ref_r = reducer(union, delta, torch.bfloat16), reducer(union, delta, torch.float64)
        applied = torch.zeros((weights.shape[0],), dtype=torch.float64, device=weights.device)
        applied[0] = 1.0
        prev = None
        for k in range(updates + 1):
            if k:
                applied[1 + (k - 1) % int(p["pool"])] += 1.0
            w = applied @ weights
            ctl_r.set_weights(w)
            ref_r.set_weights(w)
            ctl = ctl_r.repair(prev)
            rows.append(answer_gaps(as_prog(ctl), ref_r.repair(prev, follow=as_prog(ctl))))
            prev = ctl.reduct
    values = fold_gaps(rows)
    values.update(granules_off=0.0, unanswered=0.0)
    checks = make_checks(values, cell.limits)
    return {"seed": seed, "answers": len(rows), "correct": all(c.ok for c in checks),
            "numbers": {c.name: c.value for c in checks}}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--jobs", type=int, default=4)
    ap.add_argument("--updates", type=int, default=200)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from plarbench.run import _setup_paths

    _setup_paths()
    import torch

    from plarbench.harness import find_cell

    cell = find_cell(ROOT, args.workload)
    for seed in args.seeds:
        out = control_numbers(cell, seed, jobs=args.jobs, updates=args.updates,
                              device=torch.device(args.device))
        print(json.dumps({"workload": args.workload, **out}), flush=True)


if __name__ == "__main__":
    main()
