"""theta_roofline_pct.reduce: the Θ kernels' share of their HBM roofline.

The least time the card's HBM needs for the bytes each greedy iteration's
candidate evaluation needs (``plarbench.counts``), summed over the jobs'
iterations, over the device time of every kernel compiled from
``repro_torch/kernels/contingency/csrc/`` inside the jobs (their
``__global__`` functions, :data:`KERNELS`).  ``None`` where no such kernel
ran.
"""
from plarbench.counts import remaining_per_iteration, roofline_seconds, theta_bytes
from plarbench.readers import job_intervals, ok_jobs

KERNELS = ("count_kernel", "plan_kernel", "scatter_kernel", "short_tiles_kernel",
           "long_tiles_kernel", "ordered_sum_kernel", "contingency_kernel")
PATTERN = r"(?<![A-Za-z0-9_])(" + "|".join(KERNELS) + r")(?![A-Za-z0-9_])"


def read(run):
    if not run.trace.traced:
        return None
    seconds = run.trace.kernel_seconds(PATTERN, job_intervals(run))
    if seconds <= 0:
        return None
    need = sum(theta_bytes(j["granules"], remaining_per_iteration(
        j["n_attrs"], len(j["core"]), j["iterations"])) for j in ok_jobs(run))
    return 100.0 * roofline_seconds(need) / seconds
