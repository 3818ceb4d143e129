"""host_reads.reduce: device-to-host reads a job (each waits for the
device), the ``host_reads`` the program counts in its outermost ``reduce.*``
spans (``reduce.granulate`` and ``reduce.plar``), in the untraced half."""
from plarbench.program_spans import host_reads_a_job

REDUCE_SPANS = ("reduce.granulate", "reduce.plar", "reduce.theta_full", "reduce.core",
                "reduce.greedy", "reduce.iteration")


def read(run):
    return host_reads_a_job(run, REDUCE_SPANS)
