"""mesh_granulate_s.reduce: seconds of the per-shard GrC build a job, rank
0's span ``mesh.granulate`` (the row count's agreement, this shard's build,
ended by the host read of its granule count), in the untraced half."""
from plarbench.program_spans import seconds_a_job


def read(run):
    return seconds_a_job(run, "mesh.granulate")
