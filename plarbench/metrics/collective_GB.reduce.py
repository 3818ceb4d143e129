"""collective_GB.reduce: GB (10^9 bytes) handed to the mesh's collectives a
job, the program's counter ``plar_mesh_collective_bytes_total`` on rank 0
read before and after each job (the row-count agreement, the granule
tables' gather, every merge and advance), in the untraced half."""
from plarbench.readers import ok_jobs


def read(run):
    jobs = [j for j in ok_jobs(run) if "collective_bytes" in j]
    return sum(j["collective_bytes"] for j in jobs) / len(jobs) / 1e9 if jobs else None
