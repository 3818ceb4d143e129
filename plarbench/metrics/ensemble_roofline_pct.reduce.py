"""ensemble_roofline_pct.reduce: the stacked loop's candidate evaluation's
share of its HBM roofline.

The least time the card's HBM needs for the bytes each member's greedy
iterations need (``plarbench.counts``, the candidates left after the
member's core at each of its iterations), summed over the members and the
jobs, over the device's busy time inside the jobs' ``engine.dispatch_ensemble``
spans (the profiled half).  The count is the work the inputs need, whatever
implements it: frozen members, forced folds and bodies past the stop add
device time and no bytes.  ``None`` where no such span was found.
"""
from plarbench.counts import remaining_per_iteration, roofline_seconds, theta_bytes
from plarbench.program_spans import spans
from plarbench.readers import ok_jobs


def read(run):
    if not run.trace.traced:
        return None
    found = spans(run, ("engine.dispatch_ensemble",))
    busy = run.trace.busy([(s.start, s.end) for s in found]) if found else 0.0
    if busy <= 0:
        return None
    need = sum(theta_bytes(j["granules"], remaining_per_iteration(
        j["n_attrs"], len(m["core"]), m["iterations"]))
        for j in ok_jobs(run) for m in j["members"])
    return 100.0 * roofline_seconds(need) / busy
