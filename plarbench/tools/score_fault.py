"""The reach of the program's float32 Θ scores at a cell's size, and a score
fault planted under it.

``--read``: every call of the sweep kernel (``ops.sweep_theta``) in a batch
cell's reductions, or in a cold reduction of a stream cell's table at the
window's close (its granules' weights scaled by ``--scale``), is held
against Θ worked out again in float64 from the kernel's own operands.
Prints the largest gap over ``max(1, |Θ|)``: the reading a cell's
``theta_reach`` is set above.

``--noise A``: the kernel's scores come back with uniform noise in
``[-A, A]`` added, and a short run of the cell is made on each seed.
Prints ``correct`` and the numbers compared: whether the comparison sees a
score fault of that size.

    python3 plarbench/tools/score_fault.py --workload kdd99.batch --read --seeds 1 2 3
    python3 plarbench/tools/score_fault.py --workload kdd99.stream --read --scale 13 --seeds 1
    python3 plarbench/tools/score_fault.py --workload kdd99.batch --noise 2e-5 --seconds 10 \\
        --seeds 1 2 3
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def exact_scores(x_t, r_ids, d, w, n: float, *, delta: str, v_max: int, n_dec: int,
                 chunk: int = 8):
    """Θ(D|R∪{a}) in float64 for each row ``a`` of ``x_t`` from the sweep
    kernel's operands (``r_ids`` the classes of R, -1 on padding)."""
    import torch

    from plarbench.reference.plar import _dense, _theta

    live = r_ids >= 0
    r, k = _dense(r_ids[live].to(torch.int64))
    dd, ww = d[live].to(torch.int64), w[live].to(torch.float64)
    q, nq = _dense(r * n_dec + dd)
    r_of_q = torch.zeros((nq,), dtype=torch.int64, device=r.device)
    r_of_q[q] = r
    v = int(v_max)
    cell_cls = (r_of_q[:, None] * v + torch.arange(v, device=r.device)).reshape(1, -1)
    out = []
    for lo in range(0, x_t.shape[0], chunk):
        xc = x_t[lo:lo + chunk][:, live].to(torch.int64)
        nc = xc.shape[0]
        off = torch.arange(nc, device=r.device)[:, None]
        cells = torch.zeros((nc * nq * v,), dtype=torch.float64, device=r.device)
        cells.index_add_(0, (off * (nq * v) + q * v + xc).reshape(-1),
                         ww.expand(nc, -1).reshape(-1))
        cells = cells.view(nc, nq * v)
        e = torch.zeros((nc, k * v), dtype=torch.float64, device=r.device)
        e.scatter_add_(1, cell_cls.expand(nc, -1), cells)
        out.append(_theta(delta, cells, cell_cls, e, float(n), torch.float64))
    return torch.cat(out)


def _patch(ops, wrap) -> None:
    inner = ops.sweep_theta

    def sweep_theta(x_t, r_ids, d, w, n, **kw):
        return wrap(inner, x_t, r_ids, d, w, n, **kw)
    ops.sweep_theta = sweep_theta


def read_reach(cell, seeds, *, jobs: int, scale: int, device) -> None:
    import torch

    from plarbench.tables import draw_rows, make_table, prototypes
    from repro_torch.core.reduction import plar_reduce, resolve_granularity
    from repro_torch.kernels.contingency import ops

    worst = {"gap": 0.0, "calls": 0, "scores": 0}

    def wrap(inner, x_t, r_ids, d, w, n, **kw):
        out = inner(x_t, r_ids, d, w, n, **kw)
        ref = exact_scores(x_t, r_ids, d, w, float(n), delta=kw["delta"], v_max=kw["v_max"],
                           n_dec=kw["n_dec"])
        gap = ((out.to(torch.float64) - ref).abs() / ref.abs().clamp(min=1.0)).max()
        worst["gap"] = max(worst["gap"], float(gap))
        worst["calls"] += 1
        worst["scores"] += int(out.numel())
        return out
    _patch(ops, wrap)
    cfg = cell.config
    for seed in seeds:
        worst.update(gap=0.0, calls=0, scores=0)
        if cell.traffic["driver"] == "batch":
            run, rows = dict(cfg["run"]), []
            for j in range(jobs):
                gran = resolve_granularity(*make_table(cfg, seed, j, device),
                                           n_dec=int(cfg["n_dec"]), v_max=int(cfg["v_max"]),
                                           device=device)
                plar_reduce(source=gran, device=device, **run)
                rows.append(int(gran.n_total))
        else:
            p = cell.params
            protos = prototypes(cfg, seed, "stream", device)
            n = int(cfg["rows"])
            parts = [draw_rows(protos, round(n * p["initial_fraction"]), "initial")]
            parts += [draw_rows(protos, round(n * p["batch_fraction"]), "pool", b)
                      for b in range(int(p["pool"]))]
            x = torch.cat([a for a, _ in parts])
            d = torch.cat([b for _, b in parts])
            del parts, protos
            gran = resolve_granularity(x, d, n_dec=int(cfg["n_dec"]), v_max=int(cfg["v_max"]),
                                       device=device)
            del x, d
            gran = dataclasses.replace(gran, w=gran.w * scale, n_total=gran.n_total * scale)
            q = dict(p["query"])
            plar_reduce(source=gran, delta=q.pop("delta"), device=device, **q)
            rows = [int(gran.n_total)]
        print(json.dumps({"workload": cell.name, "seed": seed, "rows": rows,
                          "largest_gap_over_max1_theta": worst["gap"],
                          "kernel_calls": worst["calls"], "scores": worst["scores"]}),
              flush=True)


def plant_noise(cell, seeds, *, noise: float, seconds: float, device) -> None:
    import torch

    from plarbench.harness import run_cell
    from repro_torch.kernels.contingency import ops

    calls = [0]

    def wrap(inner, x_t, r_ids, d, w, n, **kw):
        out = inner(x_t, r_ids, d, w, n, **kw)
        gen = torch.Generator(device=out.device).manual_seed(calls[0])
        calls[0] += 1
        u = torch.rand(out.shape, generator=gen, device=out.device, dtype=torch.float64)
        return (out.to(torch.float64) + noise * (2 * u - 1)).to(out.dtype)
    _patch(ops, wrap)
    for seed in seeds:
        calls[0] = 0
        result = run_cell(ROOT, cell, seed=seed, seconds=seconds, trace=False,
                          device=str(device), log=lambda msg: None)
        print(json.dumps({"workload": cell.name, "seed": seed, "noise": noise,
                          "attempted": result["attempted"], "correct": result["correct"],
                          "checks": result["checks"]}), flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--read", action="store_true")
    mode.add_argument("--noise", type=float)
    ap.add_argument("--jobs", type=int, default=3, help="--read, batch cells: jobs a seed")
    ap.add_argument("--scale", type=int, default=13,
                    help="--read, stream cells: the table's weights times this")
    ap.add_argument("--seconds", type=float, default=10.0, help="--noise: the window")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from plarbench.run import _setup_paths

    _setup_paths()
    import torch

    from plarbench.harness import find_cell

    cell = find_cell(ROOT, args.workload)
    dev = torch.device(args.device)
    if args.read:
        read_reach(cell, args.seeds, jobs=args.jobs, scale=args.scale, device=dev)
    else:
        plant_noise(cell, args.seeds, noise=args.noise, seconds=args.seconds, device=dev)


if __name__ == "__main__":
    main()
