"""ensemble_loop_s.reduce: seconds of the stacked loop a job, the program's
span ``engine.dispatch_ensemble`` (every config's greedy selection as one
replayed CUDA graph, ended by a synchronize), in the untraced half."""
from plarbench.program_spans import seconds_a_job


def read(run):
    return seconds_a_job(run, "engine.dispatch_ensemble")
