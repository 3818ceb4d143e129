"""Every feasible tiling of the contingency kernels timed on the card, beside
the cost model's time and rank.

    python -m repro_torch.launch.time_tiles [--reps 5] [--out FILE]

At the kdd99 main-path shapes of ``chip_smoke.py`` phase 3 (G = 131,072
granules, ~24% of them padding, n_dec = 23, V = 10, nc = 41 candidates), for
each (n_bins, K) of ``CASES`` — class ids r drawn from [0, K) — and each
kernel, every tiling of ``model.feasible_tiles``: the device time of one
call (``reps`` calls captured in a CUDA graph and replayed between CUDA
events; the contingency kernel, whose output a call takes 4.9 GB at the top
n_bins, by events around ``reps`` back-to-back calls), its modeled time on
the card's spec, and its rank by each.  One JSON line a tiling, then one a
(case, kernel): Spearman's rank correlation of model and measurement, and
the measured ms of the pinned, analytic and fastest tilings.  The card's
name and power limit come first.  Needs a CUDA card; imports nothing of
JAX.
"""
from __future__ import annotations

import argparse
import json
import subprocess
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from repro_torch.launch.profile_sweep import G, N_DEC, NC, V, operands

CASES = ((160, 16), (10_240, 1_024), (1_310_720, 131_072), (1_310_720, 1))
DELTA = "PR"


def graph_ms(fn, reps: int) -> float:
    """Device ms of one call: ``reps`` calls captured in one CUDA graph and
    replayed between CUDA events."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def events_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _ranks(values: List[float]) -> np.ndarray:
    return np.argsort(np.argsort(np.asarray(values)))


def main(argv=None) -> List[Dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", default=None, help="also write every line here (JSON lines)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("time_tiles needs a CUDA card (torch.cuda.is_available() is False)")

    from repro_torch.kernels.contingency import model, ops
    from repro_torch.launch.roofline import device_spec

    dev = torch.device("cuda")
    spec = device_spec(dev)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    lines: List[Dict] = []
    for n_bins, k in CASES:
        x_t, r, d, w = operands(n_bins, k, dev)
        packed = (r[None, :] * V + x_t).contiguous()
        n = torch.tensor(float(w.sum()), device=dev)
        calls = {
            "contingency": lambda t: ops.contingency(packed, d, w, n_bins=n_bins, n_dec=N_DEC,
                                                     threads=t[0], ctas=t[1]),
            "fused": lambda t: ops.fused_theta(packed, d, w, n, delta=DELTA, n_bins=n_bins,
                                               n_dec=N_DEC, chunk=t[0], threads=t[1]),
            "sweep": lambda t: ops.sweep_theta(x_t, r, d, w, n, delta=DELTA, v_max=V,
                                               n_bins=n_bins, n_dec=N_DEC, bc=t[0], chunk=t[1],
                                               threads=t[2]),
        }
        for kernel, call in calls.items():
            if kernel == "contingency" and k != n_bins // V:
                continue                              # its time does not depend on K
            ranked = model.rank_tiles(kernel, NC, G, n_bins, N_DEC, v_max=V, delta=DELTA,
                                      spec=spec)
            rows = []
            for tiles, _cost, modeled in ranked:
                timer = events_ms if kernel == "contingency" else graph_ms
                rows.append(dict(kernel=kernel, n_bins=n_bins, K=k, tiles=list(tiles),
                                 ms=timer(lambda t=tiles: call(t), args.reps),
                                 modeled_ms=modeled * 1e3))
                torch.cuda.empty_cache()
            measured = _ranks([row["ms"] for row in rows])
            for i, row in enumerate(rows):
                row.update(model_rank=i, measured_rank=int(measured[i]), card=smi)
                print(json.dumps(row), flush=True)
            by = {tuple(row["tiles"]): row["ms"] for row in rows}
            best = min(rows, key=lambda row: row["ms"])
            rho = float(np.corrcoef(np.arange(len(rows)), measured)[0, 1]) if len(rows) > 1 else 1.0
            summary = dict(kernel=kernel, n_bins=n_bins, K=k, tilings=len(rows), spearman=rho,
                           analytic=list(ranked[0][0]), analytic_ms=by[ranked[0][0]],
                           pinned=list(model.PINNED_TILES[kernel]),
                           pinned_ms=by.get(model.PINNED_TILES[kernel]),
                           fastest=best["tiles"], fastest_ms=best["ms"], card=smi)
            print(json.dumps(summary), flush=True)
            lines += rows + [summary]
        del x_t, r, d, w, packed
        torch.cuda.empty_cache()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("".join(json.dumps(row) + "\n" for row in lines))
    return lines


if __name__ == "__main__":
    main()
