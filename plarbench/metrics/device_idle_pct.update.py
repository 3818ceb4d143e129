"""device_idle_pct.update: per cent of the updates' time (push to answer)
with no operation on the device."""
from plarbench.readers import idle_pct


def read(run):
    return idle_pct(run, [(u["start"], u["done"]) for u in run.record.get("updates", [])])
