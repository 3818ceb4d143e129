"""greedy_s.reduce: seconds of the greedy loop a job, the program's span
``reduce.greedy`` (the forced-prefix folds and every greedy iteration, ended
by the host read of the last Θ(D|R)), in the untraced half."""
from plarbench.program_spans import seconds_a_job


def read(run):
    return seconds_a_job(run, "reduce.greedy")
