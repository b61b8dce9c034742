"""Logging, phase timing and device traces for the driver.

Counterpart of ``cornell_moe_tpu/utils/logging_utils.py``: the printf-style
log helpers, a phase timer that records per-phase wall clock into a run
report, and a context that writes a ``torch.profiler`` trace where the JAX
package writes a ``jax.profiler`` one.  A phase that launched work on a
CUDA device should end in ``torch.cuda.synchronize()`` before it closes
(the driver's phases end in a host read of their result, which waits for
the device).
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np
import torch

LOGGER_NAME = "cornell_moe_tpu_torch"
logger = logging.getLogger(LOGGER_NAME)


def configure_logging(verbose: bool = False) -> logging.Logger:
    """INFO by default, DEBUG if verbose, on one stream handler."""
    handler = logging.StreamHandler()
    handler.setFormatter(logging.Formatter(
        "[%(asctime)s %(levelname).1s %(name)s] %(message)s", "%H:%M:%S"))
    logger.handlers[:] = [handler]
    logger.setLevel(logging.DEBUG if verbose else logging.INFO)
    return logger


def error_printf(msg, *args):
    logger.error(msg, *args)


def warning_printf(msg, *args):
    logger.warning(msg, *args)


def verbose_printf(msg, *args):
    logger.debug(msg, *args)


def print_matrix(matrix, name: str = "matrix"):
    """Log a matrix (a tensor or an array) at INFO."""
    if isinstance(matrix, torch.Tensor):
        matrix = matrix.detach().cpu().numpy()
    logger.info("%s =\n%s", name, np.array2string(
        np.asarray(matrix), precision=6, suppress_small=True))


class PhaseTimer:
    """Accumulates per-phase wall-clock timings across a run."""

    def __init__(self):
        self.records: List[Dict] = []

    @contextlib.contextmanager
    def phase(self, name: str, **attrs):
        """Times the block; yields ``attrs``, to which the block may add
        what it found (they are recorded with the time)."""
        start = time.time()
        try:
            yield attrs
        finally:
            self.records.append(
                {"phase": name, "seconds": time.time() - start, **attrs})
            logger.info("%s took %.2fs", name, self.records[-1]["seconds"])

    def summary(self) -> Dict[str, Dict[str, float]]:
        out: Dict[str, Dict[str, float]] = {}
        for r in self.records:
            agg = out.setdefault(
                r["phase"], {"total": 0.0, "count": 0, "max": 0.0})
            agg["total"] += r["seconds"]
            agg["count"] += 1
            agg["max"] = max(agg["max"], r["seconds"])
        return out

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({"records": self.records,
                       "summary": self.summary()}, f, indent=2)


@contextlib.contextmanager
def device_trace(log_dir: Optional[str] = None):
    """Trace the block with ``torch.profiler`` (the CPU, and the CUDA
    device when there is one) and write it as a Chrome trace,
    ``trace.json`` in ``log_dir`` (a new temporary directory when None).
    Yields the directory."""
    from torch.profiler import ProfilerActivity, profile

    log_dir = log_dir or tempfile.mkdtemp(prefix="cornell_moe_trace_")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield log_dir
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    logger.info("device trace written to %s", log_dir)
