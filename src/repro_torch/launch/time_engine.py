"""Loop time of the device engine against its poll period, on the card:

    python -m repro_torch.launch.time_engine [--periods 1,2,4,8] [--reps 3]

For each table (the kdd99 stand-in at 5,000,000 x 41, and mushroom at 2,000
rows), granulated once on the card, runs ``plar_reduce(engine="device",
backend="segment", delta="PR")`` once to capture its graph, then ``--reps``
rounds over ``--periods`` with ``engine.POLL_PERIOD`` set to each in turn.
Prints the card's ``nvidia-smi`` name and power limit, then one JSON line a
run: loop seconds, bodies replayed, bodies that selected an attribute, and
``done`` polls, all read from the ``engine.dispatch`` span.  Needs a card.
"""
from __future__ import annotations

import argparse
import json
import subprocess

TABLES = (("kdd99", 5_000_000), ("mushroom", 2_000))


def main() -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.time_engine")
    ap.add_argument("--periods", default="1,2,4,8")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()

    import torch

    from repro_torch import obs
    from repro_torch.core import engine, plar_reduce, resolve_granularity
    from repro_torch.data import scaled_paper_dataset
    from repro_torch.device import resolve_device

    dev = resolve_device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    periods = [int(p) for p in args.periods.split(",")]
    obs.enable()
    for name, rows in TABLES:
        x, d = scaled_paper_dataset(name, max_rows=rows, max_attrs=64).table()
        gran = resolve_granularity(x, d, device=dev)
        plar_reduce(source=gran, delta="PR", engine="device", device=dev)   # the capture
        for rep in range(args.reps):
            for period in periods:
                engine.POLL_PERIOD = period
                r = plar_reduce(source=gran, delta="PR", engine="device", device=dev)
                span = next(rec for rec in reversed(obs.get_tracer().records())
                            if rec.name == "engine.dispatch")
                print(json.dumps({"table": name, "rows": rows, "rep": rep, "period": period,
                                  "live_bodies": len(r.reduct),
                                  **{k: span.args[k] for k in ("loop_s", "bodies", "polls",
                                                               "captures")}}), flush=True)
        del gran
        engine.release_graphs()
    print(json.dumps({"device": torch.cuda.get_device_name(0)}))


if __name__ == "__main__":
    main()
