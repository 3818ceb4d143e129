"""mesh_loop_s.reduce: seconds of the mesh's greedy loop a job, rank 0's
span ``mesh.loop`` (the core's folds and every iteration: candidates
evaluated on each shard, merged over the data shards, the argmin, the fold;
ended by the host read of the last Θ(D|R)), in the untraced half."""
from plarbench.program_spans import seconds_a_job


def read(run):
    return seconds_a_job(run, "mesh.loop")
