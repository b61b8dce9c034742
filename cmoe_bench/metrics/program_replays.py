"""Program replays per traced iteration: the growth of the port's counter
``programs.replays`` (``ops/programs.py``) inside its outermost spans
(``driver.observe``, ``driver.recommend``) over the traced iterations.
The port records its spans only while the profiler records, that is over
the traced cycle.  Nothing where the port keeps no record of its
spans."""

LAYER = "programs"
UNIT = "replays"
SOURCE = "program_counter"
MOVES = "iter_s"
COUNTER = "programs.replays"


def read(run):
    if not run.traced:
        return None
    try:
        from cornell_moe_tpu_torch.utils import logging_utils
    except ImportError:
        return None
    records = getattr(logging_utils, "records", None)
    if records is None:
        return None
    outer = [r for r in records() if r["parent"] is None]
    if not outer:
        return None
    return sum(r["counters"].get(COUNTER, 0) for r in outer) / \
        len(run.traced)
