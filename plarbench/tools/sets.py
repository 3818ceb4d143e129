"""Sets of runs of one cell, one process a run, with the host's and the card's
state sampled beside each, and the spreads the bounds are set from.

    python3 plarbench/tools/sets.py --workload kdd99.batch --seeds 11 12 13 14 15 16 \\
        --sets 2 --seconds 51 --out chiprun_out/sets

Runs ``plarbench/run.py`` for every seed of every set (the same seeds in each
set), then once traced for each ``--traced`` seed.  Beside each run it samples
every 5 s the host's CPU time split (``/proc/stat``: the share stolen by the
hypervisor, the share busy), the CPU clock (``/proc/cpuinfo``) and the card's
SM clock, temperature and power (``nvidia-smi``).  Writes each run's output
to ``<out>/<workload>.<seed>.t<trace>.s<set>.{out,err}`` and one JSON line a
run to ``<out>/<workload>.jsonl``; prints each run's line and, at the end,
each metric's quartile spread per set (``statistics.quantiles(n=4)``: the
distance between the first and third quartiles over the median).
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def _proc_stat():
    try:
        with open("/proc/stat") as f:
            vals = [int(v) for v in f.readline().split()[1:]]
    except OSError:
        return None
    steal = vals[7] if len(vals) > 7 else 0
    idle = vals[3] + (vals[4] if len(vals) > 4 else 0)
    return sum(vals[:8]), idle, steal


def _cpu_mhz():
    try:
        with open("/proc/cpuinfo") as f:
            mhz = [float(line.split(":")[1]) for line in f if line.startswith("cpu MHz")]
    except OSError:
        return None
    return sum(mhz) / len(mhz) if mhz else None


def _card():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,temperature.gpu,power.draw",
             "--format=csv,noheader,nounits"], capture_output=True, text=True, timeout=10)
        return [float(v) for v in out.stdout.strip().splitlines()[0].split(",")]
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


class Probe:
    """The host's and the card's state, sampled while a run goes."""

    def __init__(self, period: float = 5.0):
        self.period, self.mhz, self.card = period, [], []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)

    def _loop(self):
        while not self._stop.wait(self.period):
            m, c = _cpu_mhz(), _card()
            if m is not None:
                self.mhz.append(m)
            if c is not None:
                self.card.append(c)

    def __enter__(self):
        self.stat0 = _proc_stat()
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        stat1 = _proc_stat()
        self.summary = {}
        if self.stat0 and stat1:
            total = max(stat1[0] - self.stat0[0], 1)
            self.summary["host_steal_share"] = (stat1[2] - self.stat0[2]) / total
            self.summary["host_busy_share"] = 1 - (stat1[1] - self.stat0[1]) / total
        if self.mhz:
            self.summary["host_cpu_mhz"] = statistics.mean(self.mhz)
        if self.card:
            for i, k in enumerate(("card_sm_mhz", "card_mem_mhz", "card_temp_c", "card_power_w")):
                self.summary[k] = statistics.mean(c[i] for c in self.card)
        return False


def spread(values):
    """The quartile spread over the median."""
    if len(values) < 2:
        return None
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2 if q2 else None


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--sets", type=int, default=2)
    ap.add_argument("--traced", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--root", default=str(ROOT), help="the checkout to run from")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    plan = [(s + 1, seed, 0) for s in range(args.sets) for seed in args.seeds]
    plan += [("t", seed, 1) for seed in args.traced]
    rows = []
    for set_, seed, trace in plan:
        tag = f"{args.workload}.{seed}.t{trace}.s{set_}"
        cmd = [sys.executable, "plarbench/run.py", "--workload", args.workload,
               "--seed", str(seed), "--seconds", str(args.seconds), "--trace", str(trace)]
        t0 = time.time()
        with Probe() as probe, open(out / f"{tag}.out", "w") as fo, \
                open(out / f"{tag}.err", "w") as fe:
            rc = subprocess.run(cmd, cwd=args.root, stdout=fo, stderr=fe).returncode
        lines = (out / f"{tag}.out").read_text().strip().splitlines()
        try:
            result = json.loads(lines[-1])
        except (IndexError, ValueError):
            result = {}
        row = {"tag": tag, "set": set_, "seed": seed, "trace": trace, "rc": rc,
               "wall_s": time.time() - t0, "correct": result.get("correct"),
               "attempted": result.get("attempted"),
               "metrics": {k: v["value"] for k, v in result.get("metrics", {}).items()},
               "memory_peak_bytes": result.get("device", {}).get("memory_peak_bytes"),
               "busy_s": result.get("device", {}).get("busy_s"),
               "window_s": result.get("device", {}).get("window_s"),
               "checks": {k: v["value"] for k, v in result.get("checks", {}).items()},
               **probe.summary}
        rows.append(row)
        with open(out / f"{args.workload}.jsonl", "a") as f:
            f.write(json.dumps(row) + "\n")
        print(json.dumps(row), flush=True)
    untraced = [r for r in rows if r["trace"] == 0 and r["rc"] == 0]
    names = sorted({k for r in untraced for k in r["metrics"]})
    for name in names:
        per_set = {}
        for r in untraced:
            if name in r["metrics"]:
                per_set.setdefault(r["set"], []).append(r["metrics"][name])
        print(json.dumps({"metric": name, "sets": {
            str(s): {"median": statistics.median(v), "spread": spread(v), "values": v}
            for s, v in per_set.items()}}), flush=True)


if __name__ == "__main__":
    main()
