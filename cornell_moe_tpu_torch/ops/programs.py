"""Programs built once per shape bucket: CUDA graphs on the card.

Counterpart of the JAX package's cache of compiled programs: the
``BayesianOptimizer._programs`` dict of jitted suggest and recommend
programs and ``models/mcmc._ensemble_fit_program`` (a ``functools.lru_cache``
of jitted ensemble fits).  The shape bucket keeps their input shapes fixed
across iterations, so a campaign builds its programs again only when the
number of observations crosses a bucket.

A :class:`Program` wraps a function of tensors and is built once per key of
its :class:`ProgramCache`: (stage, shape bucket, walker or start count, d,
dtype, kernel name, ...), followed by the value of every switch registered
with :func:`keyed_switch` (the kernel switches ``mcmc.LML_PALLAS``,
``covariance.USE_PALLAS`` and ``knowledge_gradient.DESCENT_PALLAS``, and
``config.KG_FANTASY_LOWP``).  A captured function reads a switch once, when
it is captured, and its graph keeps that route; keyed on the switches'
values, a program built under one setting is never replayed under another,
and flipping a switch builds each program once more per value, as the JAX
package's switches, read at every trace, retrace.  On a CUDA device a
program's first call warms the function up on a side stream, then captures
one ``torch.cuda.CUDAGraph`` over static input buffers; every call copies its inputs in, replays the
graph and hands back clones of the outputs, because the next replay
overwrites the graph's own.  The graphs of one cache share one memory pool.
On the CPU a program calls the function directly.  A function may hold an
NCCL collective (``parallel.sharding.group_captures``): the warm-up runs
it once outside the graph, where NCCL creates its communicator on first
use, and :meth:`ProgramCache.release` frees the graphs before their
process group is destroyed.  On both devices the
first call of a key is one build (the counter ``programs.builds``,
:func:`build_count`: CPU builds on the CPU, graph captures on the card),
and each call one replay (``programs.replays``, and the program's own
``replays``).  A capture is the span ``programs.capture`` (its attribute
``kind``, :func:`kind`), and no span opens inside it
(``utils.logging_utils``).

:data:`CAPTURE` is the switch, in the style of the JAX package's
``LML_PALLAS``: ``"auto"`` runs the stages through programs, ``"never"``
runs every stage eagerly, step by step.  A failed capture raises: nothing
catches it and runs the stage eagerly instead.

Counter accounting: the kernel wrappers (``ops.kernels``) count their
launches in Python, which a replay does not run, and so do the optimizers'
steps and any recorder that counts in the port's registry
(``utils.logging_utils``).  A capture records how far each counter of the
registry grew while the function was captured (``launch_growth``), puts
every counter back where it stood before the warm-up, and adds that
growth at each replay.
"""

from __future__ import annotations

import contextlib
import gc
from typing import Callable, Dict, Hashable, Optional

import torch

from cornell_moe_tpu_torch import config
from cornell_moe_tpu_torch.utils import logging_utils
from cornell_moe_tpu_torch.utils.logging_utils import span

CAPTURE = "auto"

# warm-up calls before a capture (first-call set-up of the libraries and
# kernel attributes happens there, outside the graph)
WARMUP_CALLS = 1

# name -> reader of a switch that a captured function may read
_switches: Dict[str, Callable[[], Hashable]] = {}
# the side stream of every warm-up and capture, one per device for the
# process: cuBLAS keeps a workspace (32 MiB on the card) for each stream it
# runs on, for the life of the process, so a stream per cache would leave
# one more behind with every cache
_side_streams: dict = {}


def enabled() -> bool:
    """Whether the stages run through programs (``CAPTURE`` "auto")."""
    return config.switch_on("programs.CAPTURE", CAPTURE)


def keyed_switch(name: str, read: Callable[[], Hashable]) -> None:
    """Register a switch read inside captured functions: ``read()`` gives
    its current value, and every program's key ends with ``(name,
    read())`` (:meth:`ProgramCache.get`).  Each module that owns such a
    switch registers it when it is imported."""
    _switches[name] = read


def switch_key() -> tuple:
    """``(name, value)`` of every registered switch, as they stand now."""
    return tuple((name, read()) for name, read in _switches.items())


keyed_switch("config.KG_FANTASY_LOWP", lambda: config.KG_FANTASY_LOWP)


def build_count() -> int:
    """The counter ``programs.builds``: programs built in the process."""
    return logging_utils.counters().get("programs.builds", 0)


def run(cache: Optional["ProgramCache"], key: tuple, fn: Callable,
        *inputs: torch.Tensor):
    """``fn(*inputs)``: through ``cache``'s program of ``key`` and the
    inputs' shapes, dtypes and devices while ``CAPTURE`` is "auto", called
    directly without a cache or under "never"."""
    if cache is None or not enabled():
        return fn(*inputs)
    return cache.get(key + signature(inputs), fn)(*inputs)


def signature(tensors) -> tuple:
    """The shapes, dtypes and devices of ``tensors``, for a program's
    key."""
    return tuple((tuple(t.shape), t.dtype, str(t.device)) for t in tensors)


def _clone(out):
    if isinstance(out, torch.Tensor):
        return out.clone()
    return tuple(None if t is None else t.clone() for t in out)


def kind(key) -> str:
    """A program's stage, and a chain segment's steps: "chain_64"."""
    return f"chain_{key[4]}" if key[0] == "chain" else key[0]


def by_kind(cache: "ProgramCache") -> dict:
    """Per program kind of ``cache``: its builds (the programs of that
    kind) and their replays."""
    out = {}
    for key, prog in cache.programs().items():
        entry = out.setdefault(kind(key), {"builds": 0, "replays": 0})
        entry["builds"] += 1
        entry["replays"] += prog.replays
    return out


class Program:
    """One stage's function of tensors, built on its first call (see the
    module docstring).  ``fn`` takes tensors and returns a tensor or a
    tuple of tensors (None allowed); it must not read the host."""

    def __init__(self, key: Hashable, fn: Callable, cache: "ProgramCache"):
        self.key = key
        self.fn = fn
        self._cache = cache
        self.replays = 0
        self.capture_seconds: Optional[float] = None
        self.launch_growth: dict = {}
        self._built = False
        self._graph = None
        self._static_in = None
        self._static_out = None

    def __call__(self, *inputs: torch.Tensor):
        device = inputs[0].device
        if device.type != "cuda":
            if not self._built:
                self._built = True
                logging_utils.count("programs.builds")
            self.replays += 1
            logging_utils.count("programs.replays")
            return self.fn(*inputs)
        with torch.cuda.device(device):
            if self._graph is None:
                self._capture(inputs)
                logging_utils.count("programs.builds")
            for static, x in zip(self._static_in, inputs):
                if static.shape != x.shape or static.dtype != x.dtype or \
                        static.device != x.device:
                    raise ValueError(
                        f"program {self.key}: input of shape "
                        f"{tuple(x.shape)} {x.dtype} on {x.device}, captured "
                        f"at {tuple(static.shape)} {static.dtype}")
                static.copy_(x)
            self._graph.replay()
            for name, n in self.launch_growth.items():
                logging_utils.count(name, n)
            self.replays += 1
            logging_utils.count("programs.replays")
            return _clone(self._static_out)

    def _capture(self, inputs) -> None:
        with span("programs.capture", kind=kind(self.key)) as timed, \
                logging_utils.capturing():
            self._capture_graph(inputs)
        self.capture_seconds = timed.seconds

    def _capture_graph(self, inputs) -> None:
        device = inputs[0].device
        self._static_in = [x.clone() for x in inputs]
        before = logging_utils.counters()
        side = side_stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            for _ in range(WARMUP_CALLS):
                self.fn(*self._static_in)
        torch.cuda.current_stream(device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        start = logging_utils.counters()
        with _no_collection():
            with torch.cuda.graph(graph, pool=self._cache.pool(),
                                  stream=side):
                out = self.fn(*self._static_in)
        self.launch_growth = logging_utils.growth(start)
        logging_utils.restore_counters(before)
        self._graph, self._static_out = graph, out


@contextlib.contextmanager
def _no_collection():
    """Python's automatic garbage collection held off for the block: a
    cache dropped without :meth:`ProgramCache.release` lives on in a
    reference cycle (its programs' functions hold the model that holds it)
    until the collector finds it, and a graph destroyed while another is
    being captured invalidates that capture."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()


def side_stream(device) -> "torch.cuda.Stream":
    """The device's side stream for warm-ups and captures (one per device
    for the process, :data:`_side_streams`)."""
    device = torch.device(device)
    if device not in _side_streams:
        _side_streams[device] = torch.cuda.Stream(device)
    return _side_streams[device]


class ProgramCache:
    """The programs of one model (or driver), by key; their CUDA graphs
    share one memory pool, and every cache the device's side stream."""

    def __init__(self):
        self._programs: Dict[Hashable, Program] = {}
        self._pool = None

    def get(self, key: tuple, fn: Callable) -> Program:
        """The program of ``key`` and the switches' values
        (:func:`switch_key`), made from ``fn`` on first use (``fn`` of a
        later call with the same key and values is not used)."""
        key = key + switch_key()
        prog = self._programs.get(key)
        if prog is None:
            prog = self._programs[key] = Program(key, fn, self)
        return prog

    def stepper(self, key: tuple, step: Callable, *inputs) -> Callable:
        """``(*tensors, rate) -> step(*tensors, rate, *inputs)`` through one
        program per ``key`` and the tensors' shapes: the GD steps of a
        multistart or a polish, the step size (a float) passed as a 0-d
        tensor of the first tensor's dtype, so that every step replays the
        same graph."""
        def call(*args):
            *tensors, rate = args
            prog = self.get(key + tuple(tuple(t.shape) for t in tensors),
                            step)
            rate = torch.full((), rate, dtype=tensors[0].dtype,
                              device=tensors[0].device)
            return prog(*tensors, rate, *inputs)
        return call

    def programs(self) -> Dict[Hashable, Program]:
        return dict(self._programs)

    def release(self) -> None:
        """Free every program and its graph (the next call of a key builds
        again): before the process group whose collectives they captured
        is destroyed, or when a loop moves on to new shapes."""
        if self._pool is not None:
            torch.cuda.synchronize()
        self._programs.clear()
        self._pool = None

    def pool(self):
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        return self._pool

    def __len__(self) -> int:
        return len(self._programs)
