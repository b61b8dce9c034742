"""Share of the chain's time in the traced cycle in which the card idles:
100 x the device-idle seconds inside the port's ``model.chain`` spans
(``models/mcmc.py``: the retrain's chain, its segments' draws, replays and
gate reads) over the spans' summed length, each idle stretch clipped to
its span (``trace.idle_gaps``).  Nothing where the trace holds no such
span."""

from cmoe_bench import trace

LAYER = "model"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "iter_s"
SPAN = "model.chain"


def read(run):
    if run.trace is None:
        return None
    spans = [(a, b) for name, a, b in run.trace.spans if name == SPAN]
    length = sum(b - a for a, b in spans)
    if length <= 0:
        return None
    idle = sum(b - a for lo, hi in spans
               for a, b in trace.idle_gaps(run.trace.busy, lo, hi))
    return 100.0 * idle / length
