"""Mean host time of ``recommend()`` over the window's iterations: the
grid of the ensemble mean and its polish (``ops/optimizers.py``)."""

LAYER = "optimizers"
UNIT = "ms"
SOURCE = "host_clock"
MOVES = "iter_s"


def read(run):
    vals = [it["recommend"] for it in run.iterations]
    return 1e3 * sum(vals) / len(vals) if vals else None
