"""theta_full_s.reduce: seconds of Θ(D|C) a job, the program's span
``reduce.theta_full`` (the code check and Θ(D|C), ended by the host read of
Θ), in the untraced half."""
from plarbench.program_spans import seconds_a_job


def read(run):
    return seconds_a_job(run, "reduce.theta_full")
