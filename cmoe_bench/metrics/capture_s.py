"""Host seconds the port spent building its programs over the run: the
aggregate of its ``programs.capture`` spans (``ops/programs.py``: each
CUDA graph's warm-up and capture), all in set-up while ``program_builds``
reads 0.  Nothing where the port keeps no aggregate or built nothing."""

LAYER = "programs"
UNIT = "s"
SOURCE = "host_clock"
MOVES = "setup_s"
SPAN = "programs.capture"


def read(run):
    try:
        from cornell_moe_tpu_torch.utils import logging_utils
    except ImportError:
        return None
    aggregate = getattr(logging_utils, "aggregate", None)
    if aggregate is None:
        return None
    entry = aggregate().get(SPAN)
    return None if entry is None else entry["total"]
