"""The paper's tables on the port: one function per table or figure.

    python -m repro_torch.launch.paper_tables [--table NAME ...] \
        [--device cuda|cpu] [--backend NAME] [--out FILE]

The port of ``benchmarks/paper_tables.py``: the same names, defaults and row
keys, over the port's ``plar_reduce`` / ``har_reduce`` / ``fspa_reduce`` on
the ``scaled_paper_dataset`` stand-ins (Table 5's shapes, capped dims).
Two keywords are added to every table, both handed straight to the
reductions: ``device`` (default ``"cuda"``; no card is an error) and
``backend`` (default ``"segment"``, the reductions' default), so the tables
can run on the CUDA kernel backends.

    table_6_9   — time + selected features: HAR vs FSPA vs PLAR, 4 measures
    table_10    — distributed speedup (SparkAR-analogue vs PLAR modes)
    table_11    — per-iteration time vs lane count (SDSS-shaped)
    table_12    — model-parallelism level sweep (Gisette-shaped)
    fig_9       — GrC initialization on/off

Times are wall seconds around each reduction, unrounded; on the card the
clock is read after ``torch.cuda.synchronize()``.  ``table_11``, ``table_12``
and ``fig_9`` time the second of two runs of each configuration: the first
pays the one-time costs (the kernels' build, the tile resolution, the device
engine's CUDA-graph capture), which the paper's steady-state timings
exclude.

The CLI prints the card's name and power limit (``nvidia-smi``) on its first
line, then one JSON object per row, each with its table's name in
``"table"``; ``--out`` also writes the rows there, one per line.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time
from typing import Dict, List, Optional

import torch

from repro_torch.core import fspa_reduce, har_reduce, plar_reduce
from repro_torch.data import scaled_paper_dataset
from repro_torch.device import DeviceLike, resolve_device

__all__ = ["DELTAS", "SMALL_DATASETS", "ALL_TABLES", "table_6_9", "table_10", "table_11",
           "table_12", "fig_9", "card_line", "main"]

DELTAS = ["PR", "SCE", "LCE", "CCE"]

SMALL_DATASETS = [
    "mushroom", "tic-tac-toe", "dermatology", "kr-vs-kp",
    "breast-cancer-wisconsin", "backup-large", "shuttle",
    "letter-recognition", "ticdata2000",
]


def _dataset(name: str, max_rows=20000, max_attrs=64):
    t = scaled_paper_dataset(name, max_rows=max_rows, max_attrs=max_attrs)
    return t.table()


def _clock(dev: torch.device) -> float:
    """``time.perf_counter()`` once the card's queued work is done."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


def _timed(dev: torch.device, fn):
    t0 = _clock(dev)
    out = fn()
    return _clock(dev) - t0, out


def table_6_9(deltas=DELTAS, datasets=SMALL_DATASETS, max_rows=8000, *,
              device: DeviceLike = "cuda", backend: str = "segment") -> List[Dict]:
    """Paper Tables 6-9: elapsed time + reduct size for HAR / FSPA / PLAR.

    The paper's effectiveness claim — all three algorithms select identical
    feature subsets — is asserted here, not just reported.
    """
    dev = resolve_device(device)
    rows = []
    for name in datasets:
        x, d = _dataset(name, max_rows=max_rows, max_attrs=40)
        for delta in deltas:
            res = {}
            for alg, fn in (("HAR", har_reduce), ("FSPA", fspa_reduce),
                            ("PLAR", plar_reduce)):
                dt, r = _timed(dev, lambda: fn(x, d, delta=delta, backend=backend,
                                               device=dev))
                res[alg] = (dt, r.reduct)
            assert res["HAR"][1] == res["FSPA"][1] == res["PLAR"][1], (
                name, delta, {k: v[1] for k, v in res.items()})
            rows.append({
                "dataset": name, "delta": delta,
                "har_s": res["HAR"][0],
                "fspa_s": res["FSPA"][0],
                "plar_s": res["PLAR"][0],
                "selected": len(res["PLAR"][1]),
                "speedup_plar_vs_har": res["HAR"][0] / max(res["PLAR"][0], 1e-9),
            })
    return rows


def table_10(max_rows=60000, *, device: DeviceLike = "cuda",
             backend: str = "segment") -> List[Dict]:
    """Paper Table 10: distributed-algorithm speedup on large datasets.

    HadoopAR-analogue = PLAR with GrC re-built every evaluation (the "reload
    from HDFS each iteration" cost shape); SparkAR-analogue = cached data,
    no GrC compression, no MP; PLAR = full.  Ratios mirror the paper's
    HadoopAR : SparkAR : PLAR ordering.
    """
    dev = resolve_device(device)
    rows = []
    for name in ("kdd99", "weka15360"):
        x, d = _dataset(name, max_rows=max_rows, max_attrs=30)
        for delta in DELTAS:
            def run(**kw):
                return plar_reduce(x, d, delta=delta, max_features=3, compute_core=False,
                                   backend=backend, device=dev, **kw)

            # HadoopAR-analogue: no cache — re-granulate per candidate (spark
            # mode without GrC) and 1-at-a-time evaluation.
            hadoop_s, _ = _timed(dev, lambda: run(grc_init=False, mode="spark", mp_chunk=1))
            # SparkAR-analogue: cached rows, still no GrC compression or MP.
            spark_s, _ = _timed(dev, lambda: run(grc_init=False, mode="incremental",
                                                 mp_chunk=1))
            plar_s, _ = _timed(dev, lambda: run(grc_init=True, mode="incremental",
                                                mp_chunk=64))
            rows.append({
                "dataset": name, "delta": delta,
                "hadoopAR_s": hadoop_s,
                "sparkAR_s": spark_s,
                "plar_s": plar_s,
                "speedup_sparkAR": hadoop_s / max(spark_s, 1e-9),
                "speedup_plar": hadoop_s / max(plar_s, 1e-9),
            })
    return rows


def table_11(max_rows=20000, max_attrs=128, *, device: DeviceLike = "cuda",
             backend: str = "segment") -> List[Dict]:
    """Paper Table 11: SDSS-shaped per-iteration time vs worker count.

    The paper's 32→128-core scaling is emulated by the candidate-chunk width
    (more lanes per evaluation = the MP axis the hardware parallelizes).
    Reported per-iteration wall time.
    """
    dev = resolve_device(device)
    x, d = _dataset("sdss", max_rows=max_rows, max_attrs=max_attrs)
    rows = []
    for lanes in (32, 128):
        def run():
            return plar_reduce(x, d, delta="SCE", mp_chunk=lanes, max_features=1,
                               compute_core=False, backend=backend, device=dev)

        # warm-up with the *timed* configuration: the device engine's graph
        # and the kernels' tiles key on the full static shape (capacity,
        # mp_chunk, max_features), so a sliced warm-up would not absorb them
        run()
        dt, _ = _timed(dev, run)
        rows.append({"lanes": lanes, "first_iteration_s": dt})
    return rows


def table_12(max_rows=3000, max_attrs=256, *, device: DeviceLike = "cuda",
             backend: str = "segment") -> List[Dict]:
    """Paper Table 12 / Fig 10: model-parallelism level sweep (Gisette-ish)."""
    dev = resolve_device(device)
    x, d = _dataset("gisette", max_rows=max_rows, max_attrs=max_attrs)
    rows = []
    base = None
    for level in (1, 2, 4, 8, 16, 32, 64):
        def run():
            return plar_reduce(x, d, delta="SCE", mp_chunk=level, max_features=2,
                               compute_core=False, backend=backend, device=dev)

        run()  # warm-up with the timed configuration (see table_11)
        dt, _ = _timed(dev, run)
        if base is None:
            base = dt
        rows.append({"mp_level": level, "time_s": dt,
                     "speedup_vs_dp": base / max(dt, 1e-9)})
    return rows


def fig_9(max_rows=60000, *, device: DeviceLike = "cuda",
          backend: str = "segment") -> List[Dict]:
    """Paper Fig. 9: effect of GrC-based initialization.

    Timed on the SECOND run of each configuration — the first run pays the
    one-time costs, which the paper's steady-state cluster timings exclude
    (a Spark job compiles its stages once too).
    """
    dev = resolve_device(device)
    rows = []
    for name in ("kdd99", "weka15360"):
        x, d = _dataset(name, max_rows=max_rows, max_attrs=30)
        for delta in DELTAS:
            def run(grc):
                return plar_reduce(x, d, delta=delta, grc_init=grc, max_features=3,
                                   compute_core=False, backend=backend, device=dev)

            run(True)                                  # warm-up
            with_grc, _ = _timed(dev, lambda: run(True))
            run(False)
            without, _ = _timed(dev, lambda: run(False))
            rows.append({"dataset": name, "delta": delta,
                         "with_grc_s": with_grc,
                         "without_grc_s": without,
                         "grc_speedup": without / max(with_grc, 1e-9)})
    return rows


ALL_TABLES = {
    "table_6_9": table_6_9,
    "table_10": table_10,
    "table_11": table_11,
    "table_12": table_12,
    "fig_9": fig_9,
}


def card_line(dev: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them, or
    ``cpu`` for a CPU run."""
    if dev.type != "cuda":
        return "cpu"
    p = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60)
    if p.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {p.stderr.strip()}")
    return p.stdout.strip().splitlines()[0]


def main(argv: Optional[List[str]] = None) -> List[Dict]:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.paper_tables",
                                 description="the paper's tables on the port")
    ap.add_argument("--table", action="append", choices=sorted(ALL_TABLES), default=None,
                    help="a table to run (repeatable); default every table")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--backend", default="segment",
                    choices=["segment", "onehot", "pallas", "fused", "fused_xla", "sweep",
                             "sweep_xla"])
    ap.add_argument("--out", default=None, help="also write the rows here, one JSON per line")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(json.dumps({"card": card_line(dev), "device": str(dev), "backend": args.backend}),
          flush=True)
    out = []
    for name in args.table or list(ALL_TABLES):
        for row in ALL_TABLES[name](device=dev, backend=args.backend):
            row = {"table": name, **row}
            print(json.dumps(row), flush=True)
            out.append(row)
    if args.out:
        with open(args.out, "w") as f:
            f.writelines(json.dumps(row) + "\n" for row in out)
    return out


if __name__ == "__main__":
    main()
