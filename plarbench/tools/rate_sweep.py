"""The highest update rate the reduct service sustains: a stream cell run at
each of a few fixed rates, each with its own set-up and window.  A rate is
sustained where updates do not fall further and further behind their due
times.

    python3 plarbench/tools/rate_sweep.py --workload kdd99.stream --seed 5 --seconds 20 \\
        --rates 3 3.5 4 4.5

Prints one JSON line a rate: updates, the median and 95th-percentile
latency, and the driver's line on how long updates were served and how late
they were sent.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", default="kdd99.stream")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    args = ap.parse_args(argv)

    from plarbench.run import _setup_paths

    _setup_paths()
    from plarbench.harness import find_cell, run_cell

    for rate in args.rates:
        seen = {}

        def log(msg: str, seen=seen) -> None:
            if " updates in " in msg:
                seen["served"] = msg
        cell = find_cell(ROOT, args.workload)
        cell.params["rate_per_s"] = rate
        result = run_cell(ROOT, cell, seed=args.seed, seconds=args.seconds, trace=False,
                          log=log)
        m = result["metrics"]
        print(json.dumps({"rate_per_s": rate, "updates": result["attempted"],
                          "p50_s": m["update_p50_s"]["value"],
                          "p95_s": m["update_p95_s"]["value"], "served": seen.get("served"),
                          "correct": result["correct"]}), flush=True)


if __name__ == "__main__":
    main()
