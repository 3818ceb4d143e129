"""Fit the tile cost model's rates to measured tilings.

    python -m repro_torch.launch.fit_tiles TIME_TILES.jsonl

Reads the JSON lines of ``python -m repro_torch.launch.time_tiles`` (every
feasible tiling of the three contingency kernels timed on a card at the
kdd99 shapes) and fits :class:`repro_torch.kernels.contingency.model.Costs`
by least squares on log(modeled / measured), on the H100 SXM spec.  Only the
uniform tables enter (class ids over [0, n_bins / V)): the model sees shapes
alone and takes the keys as spread over the tiles, so a skewed table at the
same n_bins is not its input.  Prints the fitted ``Costs(...)``, then, for
each (kernel, n_bins) and for the rates in the model now and the fitted
ones, Spearman's rank correlation and the measured ms of the model's pick
against the fastest.  Runs on the CPU.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
from typing import Dict, List

import numpy as np

from repro_torch.kernels.contingency import model
from repro_torch.launch.profile_sweep import G, N_DEC, NC, V
from repro_torch.launch.roofline import H100_SXM

FRACTIONS = ("mem_fill", "issue_fill", "long_fill")   # shares, fitted in (0.05, 1]
# read off one call's kernels instead (python -m repro_torch.launch.profile_sweep):
# the plan's and the ordered sum's serial chains, which only the top n_bins
# lengthens, where the short tiles grow with them
FIXED = ("plan_round_s", "sum_add_s")


def load(path: str) -> List[Dict]:
    rows = [json.loads(line) for line in open(path) if '"tiles"' in line]
    return [r for r in rows if r["K"] == r["n_bins"] // V]


def modeled_s(costs: model.Costs, row: Dict) -> float:
    cost = model.kernel_cost(row["kernel"], NC, G, row["n_bins"], N_DEC, row["tiles"],
                             v_max=V, delta="PR", spec=H100_SXM, costs=costs)
    return model.modeled_time_s(cost, H100_SXM, costs)


def _spearman(a, b) -> float:
    ra, rb = np.argsort(np.argsort(a)), np.argsort(np.argsort(b))
    return float(np.corrcoef(ra, rb)[0, 1]) if len(a) > 1 else 1.0


def fit(rows: List[Dict]) -> model.Costs:
    from scipy.optimize import least_squares

    names = [f.name for f in dataclasses.fields(model.Costs) if f.name not in FIXED]
    x0 = np.log([getattr(model.COSTS, n) for n in names])
    lo = np.array([math.log(0.05) if n in FRACTIONS else -40.0 for n in names])
    hi = np.array([0.0 if n in FRACTIONS else 40.0 for n in names])
    measured = np.log([r["ms"] * 1e-3 for r in rows])

    def costs_of(x):
        return dataclasses.replace(model.COSTS, **dict(zip(names, np.exp(x))))

    def residuals(x):
        return np.log([modeled_s(costs_of(x), r) for r in rows]) - measured

    sol = least_squares(residuals, np.clip(x0, lo + 1e-9, hi - 1e-9), bounds=(lo, hi))
    return dataclasses.replace(model.COSTS, **{n: float(f"{v:.3g}")
                                               for n, v in zip(names, np.exp(sol.x))})


def report(costs: model.Costs, rows: List[Dict], label: str) -> List[Dict]:
    out = []
    for key in sorted({(r["kernel"], r["n_bins"]) for r in rows}):
        rs = [r for r in rows if (r["kernel"], r["n_bins"]) == key]
        mod = [modeled_s(costs, r) for r in rs]
        pick = rs[int(np.argmin(mod))]
        best = min(rs, key=lambda r: r["ms"])
        out.append(dict(rates=label, kernel=key[0], n_bins=key[1], tilings=len(rs),
                        spearman=_spearman(mod, [r["ms"] for r in rs]),
                        pick=pick["tiles"], pick_ms=pick["ms"], fastest=best["tiles"],
                        fastest_ms=best["ms"]))
        print(json.dumps(out[-1]), flush=True)
    return out


def main(argv=None) -> model.Costs:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("path", help="JSON lines of repro_torch.launch.time_tiles")
    args = ap.parse_args(argv)
    rows = load(args.path)
    fitted = fit(rows)
    print(repr(fitted), flush=True)
    report(model.COSTS, rows, "model")
    report(fitted, rows, "fitted")
    return fitted


if __name__ == "__main__":
    main()
