"""Run one cell of the port's benchmark once, on the card, and print its result.

    python3 plarbench/run.py --workload kdd99.batch --seed 7 --seconds 40 --trace 0

Run from the root of a checkout.  The last line of standard output is one
JSON object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
``breakdown`` when traced, and ``checks``: each number compared with its
limit, also the last lines of standard error).  Every other line goes to
standard error.  Exits non-zero with no result where there is no CUDA card,
fewer cards than the cell asks for, or where the run loaded JAX or the JAX
package.

The program's build and tuning caches are kept at fixed paths under
``build/`` in the checkout, so only a checkout's first run builds.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHES = {
    "REPRO_TORCH_BUILD_DIR": "build/repro_torch",
    "REPRO_TORCH_AUTOTUNE_CACHE": "build/plarbench/autotune.json",
    "TORCH_EXTENSIONS_DIR": "build/plarbench/torch_extensions",
    "TRITON_CACHE_DIR": "build/plarbench/triton",
    "CUDA_CACHE_PATH": "build/plarbench/cuda_cache",
}


def _setup_paths() -> None:
    if sys.path and Path(sys.path[0]).resolve() == ROOT / "plarbench":
        sys.path.pop(0)
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    for var, rel in CACHES.items():
        os.environ[var] = str(ROOT / rel)


def _card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return out.stdout.strip().replace("\n", "; ") or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 plarbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=[0, 1], default=0)
    args = ap.parse_args(argv)
    _setup_paths()

    import torch

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    chips = {w["name"]: int(w["chips"]) for w in bench["workloads"]}.get(args.workload)
    if chips is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("refused: torch.cuda.is_available() is False (this benchmark runs on "
              "a CUDA card only)", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < chips:
        print(f"refused: the cell asks for {chips} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2

    from plarbench.harness import find_cell, format_result, run_cell

    print(f"card: {_card_line()}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          file=sys.stderr)
    print("caches: " + ", ".join(f"{k}={os.environ[k]}" for k in CACHES), file=sys.stderr)
    result = run_cell(ROOT, find_cell(ROOT, args.workload), seed=args.seed, seconds=args.seconds,
                      trace=bool(args.trace), device="cuda", t_start=T_START)
    if result is None:
        return 3
    sys.stderr.flush()
    print(format_result(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
