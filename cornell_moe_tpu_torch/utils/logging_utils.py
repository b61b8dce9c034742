"""Logging, the port's spans and counters, phase timing and device traces.

Counterpart of ``cornell_moe_tpu/utils/logging_utils.py``: the printf-style
log helpers, a phase timer for the drivers' run loops, and a context that
writes a ``torch.profiler`` trace where the JAX package writes a
``jax.profiler`` one.

Spans and counters are the port's one tracer.

- :class:`span` ``(name, **attrs)`` times a block on the host.  Every span
  adds its seconds to an aggregate per name (:func:`aggregate`: count,
  total, max).  While a ``torch.profiler`` records, it also opens
  ``torch.profiler.record_function("cmoe." + name)``, so the span lands on
  the profiler's timeline beside the device's operations, and keeps a full
  record (:func:`records`): its name, its id and its parent span's, the
  number of the outermost span it runs under (``call``: one per driver
  call), its start and end in ``time.time_ns()``, which is the clock the
  profiler stamps its CPU events with, and the growth of every counter
  inside it.  A span never syncs the device: the device's side of the
  same interval is on the profiler's timeline.  Names are
  ``<layer>.<what>``: ``driver.observe``, ``model.chain``,
  ``optimizers.polish``, ``programs.capture``, ...
- A span opened while a program is built (:func:`capturing`: a CUDA
  graph's warm-up and capture, ``ops.programs``) does nothing: a captured
  function runs no Python at a replay, so spans belong at the host's call
  sites, never inside a function that a program captures.
- :func:`count` adds to one registry of named integer counters
  (:func:`counters`): each kernel wrapper's launches
  (``kernels.lml_fused``, ...), ``programs.builds`` and
  ``programs.replays``, ``optimizers.gd_steps``, ``model.lml_plain``
  (the plain log marginal likelihood's evaluations, one per hyperparameter
  set of a batch).  A program replays the growth its capture recorded, so
  the counters read the same with programs as without.  Nothing zeroes a
  counter: a reader takes a snapshot (:func:`counters`) and reads
  :func:`growth` from it, as every span record does.
"""

from __future__ import annotations

import contextlib
import logging
import os
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np
import torch

LOGGER_NAME = "cornell_moe_tpu_torch"
logger = logging.getLogger(LOGGER_NAME)

SPAN_PREFIX = "cmoe."

_counters: Dict[str, int] = {}
# name -> [count, total seconds, max seconds]
_aggregate: Dict[str, list] = {}
_records: List[dict] = []
# the recorded spans open now, innermost last
_open: list = []
_capturing = 0
_span_ids = 0
_calls = 0
_profiler_enabled = torch._C._autograd._profiler_enabled
_clock = time.perf_counter


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


# ---------------------------------------------------------------------------
# Counters
# ---------------------------------------------------------------------------

def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` (0 before its first count)."""
    _counters[name] = _counters.get(name, 0) + n


def counters() -> Dict[str, int]:
    """A copy of every counter."""
    return dict(_counters)


def restore_counters(snapshot: Dict[str, int]) -> None:
    """Every counter back to ``snapshot`` (a :func:`counters` copy);
    counters it lacks are dropped."""
    _counters.clear()
    _counters.update(snapshot)


def growth(before: Dict[str, int]) -> Dict[str, int]:
    """How far each counter grew since ``before`` (a :func:`counters`
    copy): {name: n} of the counters that moved."""
    return {k: v - before.get(k, 0) for k, v in _counters.items()
            if v != before.get(k, 0)}


# ---------------------------------------------------------------------------
# Spans
# ---------------------------------------------------------------------------

class span:
    """``with span("<layer>.<what>", **attrs) as s:`` times the block;
    ``s.seconds`` holds its host seconds after it (see the module
    docstring)."""

    __slots__ = ("name", "attrs", "seconds", "_t0", "_fn", "_record",
                 "_before")

    def __init__(self, name: str, **attrs):
        self.name = name
        self.attrs = attrs

    def __enter__(self) -> "span":
        self._record = None
        if _capturing:
            self._t0 = None
            self.seconds = 0.0
            return self
        if _profiler_enabled():
            self._open_record()
        self._t0 = _clock()
        return self

    def __exit__(self, kind, value, tb) -> bool:
        t0 = self._t0
        if t0 is None:
            return False
        self.seconds = s = _clock() - t0
        agg = _aggregate.get(self.name)
        if agg is None:
            _aggregate[self.name] = [1, s, s]
        else:
            agg[0] += 1
            agg[1] += s
            if s > agg[2]:
                agg[2] = s
        if self._record is not None:
            self._close_record(kind, value, tb)
        return False

    def _open_record(self) -> None:
        global _span_ids, _calls
        parent = _open[-1] if _open else None
        if parent is None:
            _calls += 1
        _span_ids += 1
        self._fn = torch.profiler.record_function(SPAN_PREFIX + self.name)
        self._fn.__enter__()
        self._record = {
            "name": self.name, "id": _span_ids,
            "parent": None if parent is None else parent["id"],
            "call": _calls if parent is None else parent["call"],
            "attrs": self.attrs, "start_ns": time.time_ns()}
        self._before = dict(_counters)
        _open.append(self._record)

    def _close_record(self, kind, value, tb) -> None:
        rec = self._record
        rec["counters"] = growth(self._before)
        rec["end_ns"] = time.time_ns()
        self._fn.__exit__(kind, value, tb)
        _open.pop()
        _records.append(rec)


@contextlib.contextmanager
def capturing():
    """The block builds a program: every span opened inside it does
    nothing."""
    global _capturing
    _capturing += 1
    try:
        yield
    finally:
        _capturing -= 1


def aggregate() -> Dict[str, Dict[str, float]]:
    """Per span name since the process started: its count, total and
    largest host seconds."""
    return {name: {"count": c, "total": t, "max": m}
            for name, (c, t, m) in _aggregate.items()}


def records() -> List[dict]:
    """The spans recorded while a profiler recorded, in the order they
    closed."""
    return list(_records)


def clear_records() -> None:
    _records.clear()


class PhaseTimer:
    """A driver's run loop by phase: each phase a span ``run.<phase>``,
    and in order in ``records`` with its seconds."""

    def __init__(self):
        self.records: List[Dict] = []

    @contextlib.contextmanager
    def phase(self, name: str, **attrs):
        """Times the block; yields ``attrs``, to which the block may add
        what it found (they are recorded with the time)."""
        timed = span("run." + name)
        try:
            with timed:
                yield attrs
        finally:
            self.records.append(
                {"phase": name, "seconds": timed.seconds, **attrs})
            logger.info("%s took %.2fs", name, timed.seconds)


@contextlib.contextmanager
def device_trace(log_dir: Optional[str] = None):
    """Trace the block with ``torch.profiler`` (the CPU, and the CUDA
    device when there is one) and write it as a Chrome trace,
    ``trace.json`` in ``log_dir`` (a new temporary directory when None),
    the port's spans (``cmoe.<layer>.<what>``) among its CPU events.
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
