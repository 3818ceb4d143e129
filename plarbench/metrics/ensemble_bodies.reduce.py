"""ensemble_bodies.reduce: stacked loop bodies replayed a job, the
``bodies`` of the program's ``engine.dispatch_ensemble`` spans (forced core
folds, greedy iterations, and the bodies replayed past the stop before a
poll saw it), in the untraced half."""
from plarbench.program_spans import spans
from plarbench.readers import ok_jobs


def read(run):
    found = spans(run, ("engine.dispatch_ensemble",))
    if not found or "bodies" not in found[0].args:
        return None
    return sum(s.args["bodies"] for s in found) / len(ok_jobs(run))
