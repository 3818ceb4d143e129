"""Quickstart of the PyTorch port: attribute reduction on a mushroom-shaped table.

    PYTHONPATH=src python examples/pt_quickstart.py                 # on the card
    PYTHONPATH=src python examples/pt_quickstart.py --device cpu

The counterpart of ``examples/quickstart.py`` on ``repro_torch``: build a
decision table, run PLAR with each of the paper's four significance
measures, inspect the reduct, the core and the greedy Θ path, and
cross-check against the sequential baseline HAR (paper Tables 6–9:
identical feature subsets).  ``--device`` defaults to ``cuda``; without a
card that is an error, never a silent CPU run.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

from repro_torch.core import har_reduce, plar_reduce  # noqa: E402
from repro_torch.data import scaled_paper_dataset  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    x, d = scaled_paper_dataset("mushroom", max_rows=5644).table()
    print(f"decision table: {x.shape[0]} samples × {x.shape[1]} attributes, "
          f"{int(d.max()) + 1} classes, on {args.device}")

    for delta in ("PR", "SCE", "LCE", "CCE"):
        r = plar_reduce(x, d, delta=delta, device=args.device)
        print(f"\nΔ = {delta}")
        print(f"  reduct ({len(r.reduct)} attrs): {r.reduct}")
        print(f"  core:   {r.core}")
        print(f"  Θ(D|C) = {r.theta_full:.6f}; greedy Θ path: "
              f"{[round(t, 4) for t in r.theta_history]}")
        print(f"  evaluations: {r.n_evaluations}, elapsed: {r.elapsed_s:.2f}s")

        # the paper's consistency claim (Tables 6-9): HAR picks the same subset
        r_har = har_reduce(x, d, delta=delta, device=args.device)
        assert r_har.reduct == r.reduct, "HAR and PLAR must agree"
        print(f"  HAR agrees ({r_har.elapsed_s:.2f}s vs PLAR {r.elapsed_s:.2f}s)")


if __name__ == "__main__":
    main()
