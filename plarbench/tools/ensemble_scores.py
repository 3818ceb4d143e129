"""The reach of the stacked engine's float32 candidate scores at an ensemble
cell's size, a score fault planted under it, and the cell's control.

``--read``: every candidate score the stacked loop computes
(``candidate_theta`` inside ``engine._eval_local``, on the cell's backend) is
held against Θ worked out again in float64 from the same operands, inside
the captured graph, each measure apart.  Prints, a seed, each measure's
largest gap over ``max(1, |Θ|)``: the reading a measure's ``theta_reach`` is
set above.

``--noise A``: every candidate score comes back with uniform noise in
``[-A, A]`` added (planted before the loop's first capture, so every replay
carries it), and a short run of the cell is made on each seed.  Prints
``correct``, the numbers compared, and ``<measure>_off``: the core and
reduct decisions of that measure's members that no Θ within reach explains.

``--control``: the plain reference put in the program's place in bfloat16,
held against the float64 reference as a run holds the program, a measure
at a time (``tools/control.py``'s batch comparison under the member's
measure, its limit ``theta_gap_<measure>`` and its reach).

    python3 plarbench/tools/ensemble_scores.py --workload kdd99.ensemble --read --seeds 1 2 3
    python3 plarbench/tools/ensemble_scores.py --workload kdd99.ensemble --noise 2e-5 \\
        --seconds 15 --seeds 1 2 3
    python3 plarbench/tools/ensemble_scores.py --workload kdd99.ensemble --control --seeds 1 2
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def exact_scores(delta: str, packed, d, w, valid, n, *, n_bins: int, m: int, chunk: int = 4):
    """Θ(D|B∪{a}) in float64 for each row of ``packed`` ([nc, cap] class
    ids of B∪{a} in ``[0, n_bins)``), counted exactly from the operands the
    program's evaluation took; no host read, so it runs inside a capture."""
    import torch

    ww = torch.where(valid, w, 0).to(torch.float64)
    dd = d.to(torch.int64)
    nn = torch.as_tensor(n, device=packed.device).to(torch.float64)
    out = []
    for lo in range(0, packed.shape[0], chunk):
        p = packed[lo:lo + chunk].to(torch.int64)
        nc = p.shape[0]
        off = torch.arange(nc, device=p.device)[:, None] * (n_bins * m)
        idx = torch.where(valid, p * m + dd, 0) + off
        c = torch.zeros((nc * n_bins * m,), dtype=torch.float64, device=p.device)
        c.index_add_(0, idx.reshape(-1), ww.expand(nc, -1).reshape(-1))
        c = c.view(nc, n_bins, m)
        e = c.sum(-1)
        if delta == "PR":
            pure = (c.amax(-1) == e) & (e > 0)
            out.append(-(e * pure).sum(-1) / nn)
        elif delta == "SCE":
            ec = e[..., None].expand_as(c)
            safe = torch.where(c > 0, c, 1.0)
            terms = torch.where(c > 0, c * torch.log(safe / torch.where(c > 0, ec, 1.0)), 0.0)
            out.append(-terms.sum((-1, -2)) / nn)
        elif delta == "LCE":
            out.append((e * e).sum(-1).sub((c * c).sum((-1, -2))) / (nn * nn))
        elif delta == "CCE":
            raw = (e * e * (e - 1).clamp(min=0)).sum(-1) - (c * c * (c - 1).clamp(min=0)).sum(
                (-1, -2))
            out.append(raw / (nn * nn * (nn - 1)).clamp(min=1))
        else:
            raise ValueError(f"unknown measure: {delta!r}")
    return torch.cat(out)


def _patch(wrap) -> None:
    from repro_torch.core import engine

    inner = engine.candidate_theta

    def candidate_theta(delta, packed, d, w, valid, n, **kw):
        return wrap(inner, delta, packed, d, w, valid, n, **kw)
    engine.candidate_theta = candidate_theta


def read_reach(cell, seeds, *, jobs: int, device) -> None:
    import torch

    from plarbench.tables import make_table

    params = cell.params
    worst = {m: torch.zeros((), dtype=torch.float64, device=device) for m in params["measures"]}
    calls = torch.zeros((), dtype=torch.int64, device=device)

    def wrap(inner, delta, packed, d, w, valid, n, **kw):
        out = inner(delta, packed, d, w, valid, n, **kw)
        ref = exact_scores(delta, packed, d, w, valid, n, n_bins=kw["n_bins"], m=kw["m"])
        gap = ((out.to(torch.float64) - ref).abs() / ref.abs().clamp(min=1.0)).max()
        worst[delta].copy_(torch.maximum(worst[delta], gap))
        calls.add_(1)
        return out
    _patch(wrap)
    for seed in seeds:
        for t in list(worst.values()) + [calls]:
            t.zero_()
        granules = []
        for j in range(jobs):
            x, d = make_table(cell.config, seed, j, device)
            gran, _results, _t = cell.driver.reduce_table(cell.config, params, x, d, device)
            granules.append(int(gran.num))
            del x, d, gran
        print(json.dumps({"workload": cell.name, "seed": seed, "granules": granules,
                          "largest_gap_over_max1_theta": {m: float(t) for m, t in worst.items()},
                          "score_calls": int(calls)}), flush=True)


def plant_noise(cell, seeds, *, noise: float, seconds: float, device) -> None:
    import torch

    from plarbench.harness import run_cell

    def wrap(inner, delta, packed, d, w, valid, n, **kw):
        out = inner(delta, packed, d, w, valid, n, **kw)
        u = torch.rand(out.shape, device=out.device, dtype=torch.float64)
        return (out.to(torch.float64) + noise * (2 * u - 1)).to(out.dtype)
    _patch(wrap)
    limits = {**cell.limits, **{f"{m}_off": 0 for m in cell.params["measures"]}}
    for seed in seeds:
        torch.manual_seed(seed)
        result = run_cell(ROOT, dataclasses.replace(cell, limits=limits), seed=seed,
                          seconds=seconds, trace=False, device=str(device), log=lambda msg: None)
        print(json.dumps({"workload": cell.name, "seed": seed, "noise": noise,
                          "attempted": result["attempted"], "correct": result["correct"],
                          "checks": result["checks"]}), flush=True)


def control(cell, seeds, *, jobs: int, device) -> None:
    from plarbench.tools.control import control_numbers

    for seed in seeds:
        for m in cell.params["measures"]:
            as_batch = dataclasses.replace(
                cell, config={**cell.config, "run": {"delta": m, "compute_core": True}},
                traffic={"driver": "batch"}, theta_reach=cell.driver.member_reach(cell, m),
                limits={"core_off": 0, "reduct_off": 0,
                        "theta_gap": cell.limits[f"theta_gap_{m}"]})
            out = control_numbers(as_batch, seed, jobs=jobs, updates=0, device=device)
            print(json.dumps({"workload": cell.name, "measure": m, **out}), flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--read", action="store_true")
    mode.add_argument("--noise", type=float)
    mode.add_argument("--control", action="store_true")
    ap.add_argument("--jobs", type=int, default=2, help="--read, --control: jobs a seed")
    ap.add_argument("--seconds", type=float, default=15.0, help="--noise: the window")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from plarbench.run import _setup_paths

    _setup_paths()
    import torch

    from plarbench.harness import find_cell

    cell = find_cell(ROOT, args.workload)
    dev = torch.device(args.device)
    if args.read:
        read_reach(cell, args.seeds, jobs=args.jobs, device=dev)
    elif args.control:
        control(cell, args.seeds, jobs=args.jobs, device=dev)
    else:
        plant_noise(cell, args.seeds, noise=args.noise, seconds=args.seconds, device=dev)


if __name__ == "__main__":
    main()
