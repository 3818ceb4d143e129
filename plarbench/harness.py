"""The data-driven core of the benchmark: one run of one cell.

A cell is found by its name in ``BENCHMARK.json``; everything else by name
under ``plarbench/``:

* ``workloads/<cell>.json`` — the cell's traffic parameters, its limits for
  the numbers compared, the reach of the program's float32 Θ in this cell
  (``theta_reach``), and its ``why``;
* ``configs/<config>.json`` — the deployment: table shape, the settings the
  reduction runs with, the guarantees;
* ``traffic/<traffic>.json`` — the traffic mix: ``{"driver": kind,
  "params": {...}}``, the cell's parameters laid over the mix's;
* ``traffic/<kind>.py`` — the one driver of that kind of traffic, with
  ``setup(ctx)``, ``window(ctx, state, seconds)``, ``release(ctx, state)``
  and ``check(ctx, record)``;
* ``metrics/<metric>.py`` — one reader a metric, ``read(run)``, which returns
  the number or ``None`` where the run has nothing to read.

A traced run splits its window in two halves: the first runs without the
profiler, and the metrics the host clock or the program's spans give are
read there; the second runs under the profiler, and the ``device_trace``
metrics, ``busy_s``, ``window_s`` and the breakdown are read there.  So the
profiler's own cost never enters a host-clock reading.

A later cell, mix, driver or metric is a file added there and an entry in
``BENCHMARK.json``; no file here changes.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

import torch

from plarbench.profiling import Trace, idle_gaps, top_device_ops
from plarbench.reference.compare import Check, make_checks

__all__ = ["Cell", "Check", "Context", "Run", "find_cell", "cell_metrics", "load_module",
           "forbidden_modules", "merge_records", "run_cell", "format_result", "FORBIDDEN"]

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> List[str]:
    """Top-level names in ``sys.modules`` that the benchmark may never load,
    compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def _read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, label: str):
    """Import the Python file ``path`` (names may hold dots) as a fresh module."""
    spec = importlib.util.spec_from_file_location(f"plarbench_{label}", path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    """Everything one cell's run reads, by name."""

    name: str
    entry: dict           # the cell's entry in BENCHMARK.json
    config: dict          # configs/<config>.json
    traffic: dict         # traffic/<traffic>.json
    params: dict          # the mix's params, the cell's laid over them
    limits: Dict[str, float]
    theta_reach: dict     # how far the program's float32 Θ may sit from the exact value
    driver: Any           # traffic/<kind>.py


def find_cell(root: Path, name: str) -> Cell:
    """The cell ``name`` of the benchmark under ``root``."""
    bench = _read_json(root / "BENCHMARK.json")
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if not entries:
        known = ", ".join(w["name"] for w in bench["workloads"])
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (one of: {known})")
    entry = entries[0]
    base = root / "plarbench"
    workload = _read_json(base / "workloads" / f"{name}.json")
    for key in ("config", "traffic"):
        if workload.get(key, entry[key]) != entry[key]:
            raise ValueError(f"workloads/{name}.json says {key} {workload[key]!r}, "
                             f"BENCHMARK.json says {entry[key]!r}")
    config = _read_json(base / "configs" / f"{entry['config']}.json")
    traffic = _read_json(base / "traffic" / f"{entry['traffic']}.json")
    driver = load_module(base / "traffic" / f"{traffic['driver']}.py",
                         f"traffic_{traffic['driver']}")
    params = {**traffic.get("params", {}), **workload.get("params", {})}
    return Cell(name=name, entry=entry, config=config, traffic=traffic, params=params,
                limits=dict(workload["limits"]), theta_reach=dict(workload["theta_reach"]),
                driver=driver)


def cell_metrics(bench: dict, cell: str, trace: bool) -> List[dict]:
    """The metrics a run of ``cell`` reports: its end-to-end metrics
    untraced, its per-layer metrics traced."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    reported = {m["name"] for m in e2e}

    def reports(m: dict) -> bool:
        return cell in m["workloads"] if "workloads" in m else m["moves"] in reported
    return [m for m in bench["per_layer"] if reports(m)]


@dataclasses.dataclass
class Context:
    """What a traffic driver is handed."""

    cell: Cell
    seed: int
    device: torch.device
    trace: Trace
    log: Callable[[str], None]

    @property
    def config(self) -> dict:
        return self.cell.config

    @property
    def params(self) -> dict:
        return self.cell.params

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


@dataclasses.dataclass
class Run:
    """What a metric reader is handed: the whole window untraced; in a traced
    run, the untraced half or the traced half by the metric's ``source``."""

    cell: Cell
    setup_s: float
    window: tuple                   # host (start, end)
    peak_window_bytes: Optional[int]
    record: dict                    # the driver's record of the window
    trace: Trace


def merge_records(a: dict, b: dict) -> dict:
    """Two records of one run's window, in order: lists run on, counts add,
    anything else is the later one's."""
    out = dict(a)
    for k, v in b.items():
        if isinstance(v, list) and isinstance(a.get(k), list):
            out[k] = a[k] + v
        elif k in ("attempted", "failed"):
            out[k] = a.get(k, 0) + v
        else:
            out[k] = v
    return out


def _peak(device: torch.device) -> Optional[int]:
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def run_cell(root: Path, cell: Cell, *, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: Optional[float] = None,
             log: Callable[[str], None] = _log) -> Optional[dict]:
    """One run of ``cell`` (:func:`find_cell`): set-up, the measured window,
    the readers, the comparison with the reference.  Returns the result
    line's object, or ``None`` (after saying why) where the run may print no
    result."""
    t_start = time.perf_counter() if t_start is None else t_start
    dev = torch.device(device)
    bench = _read_json(root / "BENCHMARK.json")
    metrics = cell_metrics(bench, cell.name, trace)
    readers = {m["name"]: load_module(root / "plarbench" / "metrics" / f"{m['name']}.py",
                                      f"metric_{m['name']}") for m in metrics}
    tr = Trace(trace, dev)
    ctx = Context(cell=cell, seed=seed, device=dev, trace=tr, log=log)

    state = cell.driver.setup(ctx)
    ctx.sync()
    setup_s = time.perf_counter() - t_start
    peak_setup = _peak(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    log(f"set-up {setup_s} s; window {seconds} s; trace {int(trace)}")

    h0 = time.perf_counter()
    host_record = cell.driver.window(ctx, state, seconds / 2 if tr.enabled else seconds)
    ctx.sync()
    h1 = time.perf_counter()
    record, (w0, w1) = host_record, (h0, h1)
    if tr.enabled:
        tr.start()
        w0 = tr.mark()
        record = cell.driver.window(ctx, state, seconds - seconds / 2)
        ctx.sync()
        w1 = tr.mark()
        tr.stop()
        log(f"trace: {len(tr.ops)} device operations; {tr.found_marks} of "
            f"{len(tr.marks)} marks found on the device timeline; read in {tr.read_s}")
    peak_window = _peak(dev)

    t_read = time.perf_counter()
    untraced = Run(cell=cell, setup_s=setup_s, window=(h0, h1), peak_window_bytes=peak_window,
                   record=host_record, trace=Trace(False, dev))
    traced = Run(cell=cell, setup_s=setup_s, window=(w0, w1), peak_window_bytes=peak_window,
                 record=record, trace=tr)
    values = {}
    for m in metrics:
        v = readers[m["name"]].read(traced if m["source"] == "device_trace" else untraced)
        if v is not None:
            values[m["name"]] = {"value": float(v), "unit": m["unit"]}
    whole = merge_records(host_record, record) if tr.enabled else record
    result: Dict[str, Any] = {
        "attempted": int(whole["attempted"]),
        "failed": int(whole["failed"]),
        "metrics": values,
        "device": {
            "platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "count": int(cell.entry.get("chips", 1)),
            "memory_peak_bytes": max(peak_setup or 0, peak_window or 0),
        },
    }
    if tr.traced:
        result["device"]["busy_s"] = tr.busy([(w0, w1)])
        result["device"]["window_s"] = w1 - w0
        windows = tr.windows([(w0, w1)])
        result["breakdown"] = {
            "device_ops": top_device_ops(tr.ops, windows),
            "idle_gaps": idle_gaps(tr.ops, windows,
                                   tr.dev_phases(record.get("spans", ()))),
        }
    log(f"window {w1 - w0} s: attempted {result['attempted']}, failed {result['failed']}; "
        f"readers {time.perf_counter() - t_read} s")

    cell.driver.release(ctx, state)
    del state, untraced, traced, host_record, record
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    checks = make_checks(cell.driver.check(ctx, whole), cell.limits)
    log(f"reference {time.perf_counter() - t_ref} s")

    found = forbidden_modules()
    if found:
        log(f"refused: the run loaded {', '.join(found)} (JAX or the JAX package)")
        return None
    correct = result["failed"] == 0 and all(c.ok for c in checks)
    result = {"correct": correct, **result,
              "checks": {c.name: {"value": c.value, "limit": c.limit} for c in checks}}
    for c in checks:
        log(f"check {c.name} {c.value!r} limit {c.limit!r} {'ok' if c.ok else 'FAILED'}")
    return result


def format_result(result: dict) -> str:
    """The result line: JSON, with a number that is not finite as a string."""
    def clean(v):
        if isinstance(v, float) and not math.isfinite(v):
            return str(v)
        if isinstance(v, dict):
            return {k: clean(x) for k, x in v.items()}
        if isinstance(v, list):
            return [clean(x) for x in v]
        return v
    return json.dumps(clean(result))

