"""mesh_core_s.reduce: seconds of the gather and the core a job, rank 0's
span ``mesh.core`` (the granule tables all-gathered over the data shards,
Θ(D|C) and the core on the gathered table, ended by the host read of the
core's Θ), in the untraced half."""
from plarbench.program_spans import seconds_a_job


def read(run):
    return seconds_a_job(run, "mesh.core")
