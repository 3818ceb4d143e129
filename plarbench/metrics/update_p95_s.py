"""update_p95_s: the 95th percentile (nearest rank) of the same latencies; a
failed or refused update counts as infinitely late."""
from plarbench.readers import nearest_rank, update_latencies


def read(run):
    return nearest_rank(update_latencies(run), 0.95)
