"""reduce_s: the seconds of one reduction, the sum of every completed job's
time over the number of jobs (hand-over of the table to the result on the
host, each call ended by a synchronize)."""
from plarbench.readers import ok_jobs


def read(run):
    jobs = ok_jobs(run)
    return sum(j["total_s"] for j in jobs) / len(jobs) if jobs else None
