"""update_p50_s: the median latency of all the window's updates, from when
an update was due to its query's answer on the host."""
from plarbench.readers import median, update_latencies


def read(run):
    return median(update_latencies(run))
