"""core_s.reduce: seconds of the core a job, the program's span
``reduce.core`` (Θ(D|C\\{a}) for every attribute, ended by the host read of
the last), in the untraced half."""
from plarbench.program_spans import seconds_a_job


def read(run):
    return seconds_a_job(run, "reduce.core")
