"""greedy_idle_pct.reduce: per cent of the time inside the program's
``reduce.greedy`` spans, mapped onto the device timeline, with no operation
on the device (the profiled half)."""
from plarbench.program_spans import spans
from plarbench.readers import idle_pct


def read(run):
    found = spans(run, ("reduce.greedy",))
    return idle_pct(run, [(s.start, s.end) for s in found]) if found else None
