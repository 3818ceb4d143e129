"""granulate_s.reduce: seconds of GrC initialisation a job
(``resolve_granularity``, ended by a synchronize), by the host clock."""
from plarbench.readers import ok_jobs


def read(run):
    jobs = ok_jobs(run)
    return sum(j["granulate_s"] for j in jobs) / len(jobs) if jobs else None
