"""The program's own spans (``repro_torch.obs``), read by the per-layer
metrics that split a reduction into its steps.

Importing this module turns the program's flight recorder on.  The harness
loads a traced run's readers before its set-up, so the recorder holds every
span of the run; an untraced run, which gives the end-to-end metrics, never
loads a reader that imports this module, and its recorder stays off.

A record's time is relative to the recorder's ``Tracer.epoch``, a
``time.perf_counter()`` value: ``epoch + t_start`` is on the host clock the
jobs' marks use, which ``plarbench.profiling`` ties to the device timeline.

A run off a CUDA card reads nothing here (the harness reads the allocator's
peak only on a card): the benchmark measures the card, and the harness's
CPU tests pin the metrics that a CPU run reports.
"""
from __future__ import annotations

from typing import Collection, Dict, List, NamedTuple, Optional

from plarbench.readers import job_intervals, ok_jobs
from repro_torch import obs

__all__ = ["Span", "spans", "seconds_a_job", "outermost", "host_reads_a_job"]

obs.enable()


class Span(NamedTuple):
    name: str
    start: float          # host perf_counter seconds
    end: float
    args: Dict


def spans(run, names: Collection[str]) -> Optional[List[Span]]:
    """The closed spans named in ``names`` that lie inside one of the run's
    ok jobs, oldest first; ``None`` off the card, or where the recorder has
    dropped records that the half asked about may have held (records were
    dropped and the oldest kept one began after the half did)."""
    tracer = obs.get_tracer()
    epoch = getattr(tracer, "epoch", None)    # a program without it records no such span
    if run.peak_window_bytes is None or epoch is None:
        return None
    records = tracer.records()
    if tracer.dropped and (not records or epoch + records[0].t_start > run.window[0]):
        return None
    jobs = job_intervals(run)
    out = []
    for r in records:
        if r.ph != "X" or r.name not in names:
            continue
        s = epoch + r.t_start
        e = s + r.dur
        if any(a <= s and e <= b for a, b in jobs):
            out.append(Span(r.name, s, e, r.args or {}))
    return out


def seconds_a_job(run, name: str) -> Optional[float]:
    """Seconds inside the spans ``name``, over the run's ok jobs."""
    found = spans(run, (name,))
    if not found:
        return None
    return sum(s.end - s.start for s in found) / len(ok_jobs(run))


def outermost(found: List[Span]) -> List[Span]:
    """The spans no other span of ``found`` contains (one thread's spans
    nest, so these hold the others)."""
    out: List[Span] = []
    for s in sorted(found, key=lambda s: (s.start, -s.end)):
        if not out or s.start >= out[-1].end:
            out.append(s)
    return out


def host_reads_a_job(run, names: Collection[str]) -> Optional[float]:
    """The ``host_reads`` of the outermost spans among ``names``, summed
    over the run's ok jobs, a job."""
    found = spans(run, names)
    if not found:
        return None
    return sum(s.args.get("host_reads", 0) for s in outermost(found)) / len(ok_jobs(run))
