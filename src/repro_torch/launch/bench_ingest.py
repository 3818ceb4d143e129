"""Streaming GrC ingestion benchmark on the port: build throughput and peak
memory (the port of ``benchmarks/ingest_bench.py``).

    python -m repro_torch.launch.bench_ingest [--device cuda|cpu] [--section NAME]

* ``ingest_stream_vs_monolithic`` — the same table through both ingestion
  paths (``core.granularity.build_granularity`` over the whole table, and
  ``build_granularity_streaming`` over its chunks), each in its own
  subprocess so its host peak is clean per path (RSS high-water marks only
  grow within a process).  The host peak is the child's resident set
  sampled every millisecond (``/proc/self/statm``): its ``ru_maxrss``,
  which JAX's benchmark reads, also counts the process it was forked from,
  and so did ``VmHWM`` on the card's machine (29,617–29,620 MB for every
  child of ``chip_smoke.py``).  On the card each child
  also reports ``torch.cuda.max_memory_allocated``.  The granule counts of
  the two paths must be equal (asserted).
* ``ingest_paper_scale`` — kdd99 at its full Table-5 shape (5,000,000 x
  41), streaming only: the monolithic path at this shape is what the
  streaming build exists to avoid.

The JAX benchmark's shapes: kdd99 capped to 1,000,000 rows (chunks of
65,536) and shuttle whole (58,000 rows, chunks of 8,192).  It sets no
wall-clock bound; the host RSS ratio is reported.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from typing import Dict, List, Optional, Sequence

from repro_torch.launch.bench_common import main as bench_main

__all__ = ["BOUNDS", "SECTIONS", "SHAPES", "ingest", "ingest_paper_scale",
           "ingest_stream_vs_monolithic"]

SHAPES = [("kdd99", 1_000_000, 65536), ("shuttle", 58_000, 8192)]
BOUNDS: list = []

_CHILD = r"""
import dataclasses, json, os, resource, sys, threading, time
import torch
mode, name, n_rows, chunk_rows, device = (sys.argv[1], sys.argv[2], int(sys.argv[3]),
                                         int(sys.argv[4]), sys.argv[5])
from repro_torch.core.granularity import build_granularity, build_granularity_streaming
from repro_torch.data.pipeline import paper_dataset
from repro_torch.device import resolve_device

# the host peak: this process's resident set sampled every millisecond
peak, done = [0], threading.Event()
def sample():
    page = os.sysconf("SC_PAGE_SIZE")
    while not done.is_set():
        with open("/proc/self/statm") as f:
            peak[0] = max(peak[0], int(f.read().split()[1]) * page)
        done.wait(0.001)
sampler = threading.Thread(target=sample, daemon=True)
if os.path.exists("/proc/self/statm"):
    sampler.start()

dev = resolve_device(device)
t = paper_dataset(name)
if n_rows:
    t = dataclasses.replace(t, n_rows=n_rows)
on_card = dev.type == "cuda"
if on_card:
    torch.cuda.reset_peak_memory_stats(dev)
t0 = time.perf_counter()
if mode == "monolithic":
    x, d = t.table()
    g = build_granularity(torch.from_numpy(x).to(dev), torch.from_numpy(d).to(dev),
                          n_dec=t.n_dec, v_max=t.v_max)
else:
    g = build_granularity_streaming(t.chunks(chunk_rows), n_dec=t.n_dec, v_max=t.v_max,
                                    device=dev)
granules = int(g.num)
elapsed = time.perf_counter() - t0
done.set()
if sampler.is_alive():
    sampler.join()
    rss = peak[0] / 2 ** 20
else:   # no /proc: ru_maxrss (KiB on linux), which also counts the forking parent
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024
out = {"granules": granules, "elapsed_s": elapsed, "peak_rss_mb": rss,
       "device_peak_mb": torch.cuda.max_memory_allocated(dev) / 2 ** 20 if on_card else None}
print(json.dumps(out))
"""


def ingest(mode: str, name: str, n_rows: int, chunk_rows: int, device="cuda") -> Dict:
    """Run one ingestion in a fresh Python; return its self-reported stats."""
    src = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = {**os.environ, "PYTHONPATH": src + os.pathsep + os.environ.get("PYTHONPATH", "")}
    r = subprocess.run([sys.executable, "-c", _CHILD, mode, name, str(n_rows),
                        str(chunk_rows), str(device)],
                       env=env, capture_output=True, text=True, timeout=1800)
    if r.returncode != 0:
        raise RuntimeError(f"ingest child failed:\n{r.stderr[-4000:]}")
    return json.loads(r.stdout.strip().splitlines()[-1])


def _row(name: str, mode: str, n_rows: int, chunk_rows: int, stats: Dict) -> Dict:
    return {"dataset": name, "rows": n_rows, "mode": mode,
            "chunk_rows": chunk_rows if mode == "streaming" else "-",
            "granules": stats["granules"], "elapsed_s": stats["elapsed_s"],
            "peak_rss_mb": stats["peak_rss_mb"], "device_peak_mb": stats["device_peak_mb"],
            "krows_per_s": n_rows / max(stats["elapsed_s"], 1e-9) / 1e3}


def ingest_stream_vs_monolithic(*, device="cuda", shapes=SHAPES) -> List[Dict]:
    """Both paths on each shape; the granule counts must agree."""
    rows: List[Dict] = []
    for name, n_rows, chunk_rows in shapes:
        mono = ingest("monolithic", name, n_rows, chunk_rows, device)
        stream = ingest("streaming", name, n_rows, chunk_rows, device)
        assert mono["granules"] == stream["granules"], (name, mono, stream)
        rows.append(_row(name, "monolithic", n_rows, chunk_rows, mono))
        rows.append(_row(name, "streaming", n_rows, chunk_rows, stream))
        rows.append({"dataset": name, "rows": n_rows, "mode": "rss_ratio",
                     "rss_ratio": mono["peak_rss_mb"] / stream["peak_rss_mb"]})
    return rows


def ingest_paper_scale(*, device="cuda", chunk_rows: int = 65536) -> List[Dict]:
    """kdd99 at the full Table-5 shape (5M x 41), streaming only."""
    from repro_torch.data.pipeline import paper_dataset

    name = "kdd99"
    n_rows = paper_dataset(name).n_rows
    stream = ingest("streaming", name, 0, chunk_rows, device)
    return [_row(name, "streaming", n_rows, chunk_rows, stream)]


SECTIONS = {
    "ingest_stream_vs_monolithic": ingest_stream_vs_monolithic,
    "ingest_paper_scale": ingest_paper_scale,
}


def main(argv: Optional[Sequence[str]] = None):
    # the paper-scale section runs when named (``--section``), as in the JAX benchmarks
    return bench_main("bench_ingest", SECTIONS, BOUNDS, argv,
                      default=["ingest_stream_vs_monolithic"])


if __name__ == "__main__":
    main()
