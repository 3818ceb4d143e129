"""device_idle_pct.reduce: per cent of the jobs' time (hand-over to result)
with no operation on the device; table generation between jobs left out."""
from plarbench.readers import idle_pct, job_intervals


def read(run):
    return idle_pct(run, job_intervals(run))
