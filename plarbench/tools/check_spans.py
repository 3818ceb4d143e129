"""Do the service's spans end when the device does?  A traced run of a
stream cell in which every ``DatasetHandle.update`` (inside
``scheduler.merge``) and ``DatasetHandle.reduce`` (inside
``scheduler.dispatch``) is followed by a ``torch.cuda.synchronize()``.  The
seconds each synchronize waited is the device work still queued when the
call returned, and so when its span closed: near zero means the span's end
waits for the device.

    python3 plarbench/tools/check_spans.py --workload kdd99.stream --seed 11 --seconds 20

Prints one JSON line: the waits (count, median, largest) a call, and the
cell's per-layer metrics and answers' checks from that run.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", default="kdd99.stream")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    args = ap.parse_args(argv)

    from plarbench.run import _setup_paths

    _setup_paths()
    import torch

    from plarbench.harness import find_cell, format_result, run_cell
    from repro_torch.service.state import DatasetHandle

    waits = {"update": [], "reduce": []}

    def synced(name):
        inner = getattr(DatasetHandle, name)

        def call(self, *a, **k):
            out = inner(self, *a, **k)
            t = time.perf_counter()
            torch.cuda.synchronize()
            waits[name].append(time.perf_counter() - t)
            return out
        setattr(DatasetHandle, name, call)

    for name in waits:
        synced(name)
    result = run_cell(ROOT, find_cell(ROOT, args.workload), seed=args.seed,
                      seconds=args.seconds, trace=True)
    print(json.dumps({name: {"calls": len(w), "median_s": statistics.median(w),
                             "max_s": max(w)} for name, w in waits.items() if w}))
    print(format_result(result))


if __name__ == "__main__":
    main()
