"""Where the device waits inside a cell's work, named by the program's own
spans.  One cell's set-up and one profiled window, driven by the harness's
own pieces (``find_cell``, ``Context``, ``Trace``, the cell's driver), with
the program's flight recorder on (``plarbench.program_spans``):

    python3 plarbench/tools/span_gaps.py --workload kdd99.batch --seed 11 --seconds 10
    python3 plarbench/tools/span_gaps.py --control 30 --seed 11

Prints one JSON line, over the window's units (a batch cell's ok jobs, a
stream cell's updates; with ``--control``, the control's one unit):

* ``idle_gaps``: the ten longest stretches with nothing on the device, each
  named by the innermost span around its middle (the program's spans, then
  the driver's phases: ``granulate``, ``loop``, ``update``);
* ``spans``: for each span name, its count, seconds, the device-idle share
  of its time, ``ends_in_op_share``, the share of its ends at which device
  work was still running or queued (near 0: the span ends with the
  device), and its longest instance with that instance's attributes;
* ``outside_share``: the share of the units' time outside every program
  span but ``scheduler.window``;
* ``records_a_unit``, ``dropped``: what the recorder wrote a unit, and lost;
* ``epoch_gap_s`` (stream cells): the widest gap between the driver's span
  times (placed on the host clock by a dummy event) and the same records
  placed through ``Tracer.epoch``;
* ``clock``: how the host clock is tied to the device timeline.  The
  harness ties them on the marks within 1 ms of the window's first; on the
  card the marks' residuals spread over milliseconds under these loads, so
  a span end placed through any one tie can land a fraction of a
  millisecond to milliseconds off: more than its distance from the device
  work around it.  So this tool puts a mark right after every span closes
  and decides ``ends_in_op_share`` on the device timeline alone: a mark
  launched while device work is still queued starts as that work ends (a
  microsecond or two after the operation before it), one launched on an
  idle device after the launch's own latency (:data:`QUEUED_S`).  The
  idle shares and gaps use the least residual of all marks paired in
  order; ``harness_late_s`` is how much later the harness's tie places
  host times, ``mark_lag_max_s`` the marks' widest residual above the
  least, and ``ends_in_op_share_by_clock`` (per span) the share of ends that
  the tie places inside a running operation.
"""
from __future__ import annotations

import argparse
import bisect
import collections
import json
import statistics
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

OUTER = "scheduler.window"      # spans a whole batching window, waits included
# A kernel queued behind another starts about a microsecond after it ends; one
# launched on an idle device starts at least the launch latency (several
# microseconds) after the call, which comes after the span's host read.
QUEUED_S = 3e-6


def _union(intervals):
    """Seconds covered by the union of ``(start, end)`` intervals."""
    total, reach = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > reach:
            total += e - max(s, reach)
            reach = e
    return total


def _running(ops, t: float):
    """The device operations running at device time ``t``: their name
    indices, seconds since they began and seconds until they end."""
    i = int(np.searchsorted(ops.starts, t - ops._longest, side="left"))
    j = int(np.searchsorted(ops.starts, t, side="left"))
    keep = ops.ends[i:j] > t
    return ops.ids[i:j][keep], t - ops.starts[i:j][keep], ops.ends[i:j][keep] - t


def _ends_in_ops(tr, ends, marks) -> dict:
    """Whether device work still ran at span ends: from the device start of
    the mark put right after each end (``marks``, ``None`` where there is
    none) against the end of the operations before it; and, for
    comparison, where the clock tie places the ends (host times)."""
    out = {}
    starts, reach = tr.ops.starts, np.maximum.accumulate(tr.ops.ends)
    gaps = []
    for d in marks:
        j = int(np.searchsorted(starts, d, side="left")) if d is not None else 0
        if j:
            gaps.append(d - float(reach[j - 1]))
    if gaps:
        out["ends_in_op_share"] = sum(g < QUEUED_S for g in gaps) / len(gaps)
        out["idle_after_end_s"] = statistics.median(gaps)
    hits = [_running(tr.ops, tr.dev(e)) for e in ends]
    inside = [h for h in hits if len(h[0])]
    out["ends_in_op_share_by_clock"] = len(inside) / len(ends)
    if inside:
        names = collections.Counter(tr.ops.names[int(h[0][0])][:60] for h in inside)
        out["end_ops_by_clock"] = names.most_common(2)
    return out


def _tie_on_every_mark(found: dict, own=frozenset()):
    """A clock tie for ``plarbench.profiling``: the least device-minus-host
    residual over every mark, paired in order (where every mark was found;
    else the harness's own tie).  Records in ``found`` that tie, the
    harness's tie over its own marks (those not in ``own``, the host times
    of this tool's marks), the marks' widest lag, and each host mark's
    device start."""
    from plarbench import profiling

    harness = profiling._tie_clocks

    def tie(dev_marks, host_marks, within=1e-3):
        if len(dev_marks) != len(host_marks):
            found["harness"] = harness(dev_marks, host_marks, within)
            return found["harness"]
        pairs = list(zip(sorted(dev_marks), sorted(host_marks)))
        found["device_of"] = {h: d for d, h in pairs}
        theirs = [(d, h) for d, h in pairs if h not in own]
        found["harness"] = harness([d for d, _ in theirs], [h for _, h in theirs], within)
        res = [d - h for d, h in pairs]
        found["least"] = min(res)
        found["mark_lag_max_s"] = max(res) - min(res)
        return found["least"]
    return tie


def _mark_span_ends(tracer, tr, own: dict) -> None:
    """Put a clock mark (``tr.mark()``) right after every span ``tracer``
    closes while the profiler records: ``own`` maps its host time to the
    span's end."""
    record = tracer._record

    def marked(name, ph, t0, dur, args):
        record(name, ph, t0, dur, args)
        if ph == "X" and tr.profiling:
            own[tr.mark()] = t0 + dur
    tracer._record = marked


def _nearest(keys, by_time: dict, t: float, within: float = 1e-6):
    """The value of ``by_time``'s key (``keys`` sorted) nearest ``t``,
    within ``within``."""
    i = bisect.bisect_left(keys, t)
    near = [k for k in keys[max(i - 1, 0):i + 1] if abs(k - t) <= within]
    return by_time[near[0]] if near else None


def control(n: int, device, size: int = 4096) -> None:
    """The check of ``ends_in_op_share``: ``n`` spans that close while their
    device work is still queued, then ``n`` that close at a read of it."""
    import torch

    from repro_torch import obs

    a = torch.randn(size, size, device=device)
    b = a @ a
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    for _ in range(n):
        with obs.span("control.queued"):
            b = a @ (a @ b)
    for _ in range(n):
        with obs.span("control.read"):
            b = a @ (a @ b)
            float(b[0, 0])


def summarize(tr, records, epoch: float, units, phases=(), driver_spans=(),
              marks_after=None, harness_late_s=None) -> dict:
    """The tool's numbers from a finished window: ``tr`` the harness's
    ``Trace`` (traced or not), ``records`` the recorder's records, ``units``
    the host ``(start, end)`` of each job or update, ``phases`` the driver's
    host phases, ``driver_spans`` a stream record's ``(name, start, end)``,
    ``marks_after`` each span end's (host) following mark's device start,
    ``harness_late_s`` how much later than ``tr``'s tie the harness's own
    places host times."""
    from plarbench.profiling import idle_gaps

    spans = [(r.name, epoch + r.t_start, epoch + r.t_start + r.dur, r.args or {})
             for r in records if r.ph == "X"
             and any(a <= epoch + r.t_start and epoch + r.t_start + r.dur <= b
                     for a, b in units)]
    unit_s = sum(b - a for a, b in units)
    covered = sum(_union([(max(s, a), min(e, b)) for n, s, e, _ in spans
                          if n != OUTER and s < b and e > a]) for a, b in units)
    out = {"units": len(units), "unit_s": unit_s,
           "outside_share": 1.0 - covered / unit_s if unit_s > 0 else None,
           "records_a_unit": sum(1 for r in records if any(
               a <= epoch + r.t_start <= b for a, b in units)) / max(len(units), 1)}
    by_name: dict = {}
    for n, s, e, args in spans:
        by_name.setdefault(n, []).append((s, e, args))
    marks_after = marks_after or {}
    keys = sorted(marks_after)
    table = {}
    for n, found in sorted(by_name.items()):
        longest = max(found, key=lambda f: f[1] - f[0])
        row = {"count": len(found), "seconds": sum(e - s for s, e, _ in found),
               "max_s": longest[1] - longest[0], "max_args": longest[2]}
        if tr.traced:
            busy = tr.busy([(s, e) for s, e, _ in found])
            row["idle_share"] = 1.0 - busy / row["seconds"] if row["seconds"] > 0 else None
            if harness_late_s is not None and row["seconds"] > 0:
                late = tr.busy([(s + harness_late_s, e + harness_late_s) for s, e, _ in found])
                row["idle_share_harness_tie"] = 1.0 - late / row["seconds"]
            ends = [e for _s, e, _ in found]
            row.update(_ends_in_ops(tr, ends, [_nearest(keys, marks_after, e) for e in ends]))
        table[n] = row
    out["spans"] = table
    if tr.traced:
        named = [(n, s, e) for n, s, e, _ in spans] + list(phases)
        out["idle_gaps"] = idle_gaps(tr.ops, tr.windows(units), tr.dev_phases(named))
    if driver_spans:
        mine = [(r.name, epoch + r.t_start) for r in records
                if r.ph == "X" and r.name in {n for n, _s, _e in driver_spans}]
        out["epoch_gap_s"] = max((abs(ds - s) for (dn, ds, _de), (n, s) in
                                  zip(driver_spans, mine) if dn == n), default=None)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", help="the cell to drive")
    ap.add_argument("--control", type=int, default=0,
                    help="instead of a cell: N spans over queued work, N at a read")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--device", default="cuda", help="cpu: a rehearsal, no profile")
    args = ap.parse_args(argv)
    if bool(args.workload) == bool(args.control):
        ap.error("give --workload or --control")

    from plarbench.run import _setup_paths

    _setup_paths()
    import torch

    from plarbench import profiling, program_spans  # noqa: F401  (turns the recorder on)
    from plarbench.harness import Context, _log, find_cell
    from plarbench.profiling import Trace
    from repro_torch import obs

    obs.enable()
    tie: dict = {}
    own: dict = {}
    profiling._tie_clocks = _tie_on_every_mark(tie, own)

    dev = torch.device(args.device)
    tr = Trace(True, dev)
    if args.control:
        torch.manual_seed(args.seed)
        name, record = "control", {}
    else:
        cell = find_cell(ROOT, args.workload)
        name = cell.name
        ctx = Context(cell=cell, seed=args.seed, device=dev, trace=tr, log=_log)
        state = cell.driver.setup(ctx)
        ctx.sync()
    _mark_span_ends(obs.get_tracer(), tr, own)
    tr.start()
    w0 = tr.mark()
    if args.control:
        control(args.control, dev, 4096 if dev.type == "cuda" else 64)
    else:
        record = cell.driver.window(ctx, state, args.seconds)
        ctx.sync()
    w1 = tr.mark()
    tr.stop()
    tracer = obs.get_tracer()
    if args.control:
        units = [(w0, w1)]
    elif "updates" in record:
        units = [(u["start"], u["done"]) for u in record["updates"] if u["ok"]]
    else:
        units = [(j["t0"], j["t2"]) for j in record["jobs"] if j["ok"]]
    late = tie["harness"] - tie["least"] if "least" in tie else None
    out = {"workload": name, "seed": args.seed, "window_s": w1 - w0,
           "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
           **summarize(tr, tracer.records(), tracer.epoch, units, tr.phases,
                       record.get("spans", ()),
                       {end: tie["device_of"][h] for h, end in own.items()
                        if h in tie.get("device_of", {})}, late),
           "dropped": tracer.dropped, "recorded": tracer.recorded,
           "clock": {"marks": len(tr.marks), "found": tr.found_marks, "own_marks": len(own),
                     "harness_late_s": late,
                     "mark_lag_max_s": tie.get("mark_lag_max_s")}}
    if not args.control:
        cell.driver.release(ctx, state)
    print(json.dumps(out, default=repr))


if __name__ == "__main__":
    main()
