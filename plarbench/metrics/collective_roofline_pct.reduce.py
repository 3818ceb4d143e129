"""collective_roofline_pct.reduce: the mesh collectives' share of their
NVLink roofline, on rank 0.

The least time rank 0's NVLink needs to receive what the spans recorded
(``plarbench.counts_mesh``): each ``mesh.core`` span's all-gather of
``gathered_bytes`` and each ``all_reduce`` ``mesh.iteration`` span's
all-reduces of ``bytes``, over the device time of rank 0's NCCL kernels
inside those spans (the profiled half).  Only the kernels whose bytes the
spans recorded count: iterations of another schedule, the granulation's
agreement, the core's folds and the jobs' barriers are left out of both.
``None`` where no such kernel ran.
"""
from plarbench.counts_mesh import all_gather_received, all_reduce_received, nvlink_seconds
from plarbench.program_spans import spans

PATTERN = r"(?i)nccl"


def read(run):
    if not run.trace.traced:
        return None
    found = [s for s in spans(run, ("mesh.core", "mesh.iteration")) or ()
             if s.name == "mesh.core" or s.args.get("collective") == "all_reduce"]
    received = sum(all_gather_received(s.args["gathered_bytes"], s.args["n_data"])
                   if s.name == "mesh.core" else all_reduce_received(s.args["bytes"])
                   for s in found)
    seconds = run.trace.kernel_seconds(PATTERN, [(s.start, s.end) for s in found])
    if seconds <= 0 or received <= 0:
        return None
    return 100.0 * nvlink_seconds(received) / seconds
