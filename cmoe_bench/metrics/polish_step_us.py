"""Host time of one step of the recommendation's polish in the traced
cycle: the summed length of the port's ``optimizers.polish`` spans
(``bayes_opt.recommend_from_guesses``) over the ``optimizers.gd_steps``
the port counted inside them (``ops/optimizers.py``), in microseconds.
The port records its spans only while the profiler records, that is over
the traced cycle.  Nothing where the trace holds no such span or the port
keeps no record of its spans."""

LAYER = "optimizers"
UNIT = "us"
SOURCE = "device_trace"
MOVES = "iter_s"
SPAN = "optimizers.polish"
COUNTER = "optimizers.gd_steps"


def read(run):
    if run.trace is None:
        return None
    try:
        from cornell_moe_tpu_torch.utils import logging_utils
    except ImportError:
        return None
    records = getattr(logging_utils, "records", None)
    if records is None:
        return None
    length = sum(b - a for name, a, b in run.trace.spans if name == SPAN)
    steps = sum(r["counters"].get(COUNTER, 0) for r in records()
                if r["name"] == SPAN)
    if length <= 0 or steps <= 0:
        return None
    return length * 1e-3 / steps
