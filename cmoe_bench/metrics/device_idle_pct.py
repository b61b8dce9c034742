"""Share of the traced cycle in which no operation ran on the device:
100 (1 - the union of the device operations' intervals / the cycle's
length), from ``torch.profiler``."""

LAYER = "device"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "iter_s"


def read(run):
    if run.trace is None or run.trace.window_s <= 0 or \
            run.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
