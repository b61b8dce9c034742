"""Mean host time of ``observe()`` over the window's iterations less the
harness's own evaluations of the objective: the refit and the gated chain
(``models/mcmc.py``, ``gp.py``, ``likelihood.py``)."""

LAYER = "model"
UNIT = "ms"
SOURCE = "host_clock"
MOVES = "iter_s"


def read(run):
    vals = [it["observe"] - it["evaluate"] for it in run.iterations]
    return 1e3 * sum(vals) / len(vals) if vals else None
