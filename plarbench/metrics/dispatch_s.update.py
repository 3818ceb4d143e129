"""dispatch_s.update: seconds inside the service's ``scheduler.dispatch``
span (the warm repair), a window update on average."""
from plarbench.readers import span_seconds


def read(run):
    return span_seconds(run, "scheduler.dispatch")
