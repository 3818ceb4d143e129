"""merge_s.update: seconds inside the service's ``scheduler.merge`` span (the
coalesced fold of the pushed rows), a window update on average."""
from plarbench.readers import span_seconds


def read(run):
    return span_seconds(run, "scheduler.merge")
