"""loop_s.reduce: seconds of ``plar_reduce`` a job (Θ(D|C), the core, the
greedy host loop; ended by a synchronize), by the host clock."""
from plarbench.readers import ok_jobs


def read(run):
    jobs = ok_jobs(run)
    return sum(j["loop_s"] for j in jobs) / len(jobs) if jobs else None
