"""Phase timing for the driver.

Counterpart of ``PhaseTimer`` in ``cornell_moe_tpu/utils/logging_utils.py``.
A phase that launched work on a CUDA device should end in
``torch.cuda.synchronize()`` before it closes (the driver's phases end in a
host read of their result, which waits for the device).
"""

from __future__ import annotations

import contextlib
import json
import logging
import time
from typing import Dict, List

LOGGER_NAME = "cornell_moe_tpu_torch"
logger = logging.getLogger(LOGGER_NAME)


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
