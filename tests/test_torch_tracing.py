"""The port's tracer (``utils/logging_utils``): spans and counters on the
profiler's clock, where the driver, the model, the optimizers and the
programs open them, and the benchmark's readers of them
(``cmoe_bench/metrics``), on the CPU.  The capture of a CUDA graph is
checked on the card (marker ``cuda``)."""

import importlib.util
import os
import time
import timeit
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cmoe_bench import trace as trace_mod
from cornell_moe_tpu_torch import bayes_opt as tbo
from cornell_moe_tpu_torch.models import mcmc as tmcmc
from cornell_moe_tpu_torch.ops import kernels, programs
from cornell_moe_tpu_torch.ops import optimizers as topt
from cornell_moe_tpu_torch.ops.domains import TensorProductDomain
from cornell_moe_tpu_torch.tools import scale_out
from cornell_moe_tpu_torch.utils import logging_utils as lu
from cornell_moe_tpu_torch.utils.synthetic_functions import Branin

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = [ProfilerActivity.CPU]


@pytest.fixture(autouse=True)
def no_records():
    lu.clear_records()
    yield
    lu.clear_records()


def reader(name):
    """``cmoe_bench/metrics/<name>.py``, loaded by path as the harness
    loads it."""
    path = os.path.join(REPO, "cmoe_bench", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"cmoe_bench.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_driver_spans_nest_under_their_call():
    """Under a profiler every span of a driver call shares that call's
    number, lies inside its parent and has the parent the layers give it:
    the chain inside the training, the fits beside it, the grid and the
    polish inside the recommendation."""
    bo = tbo.BayesianOptimizer(
        objective_func=Branin(), method="KG", num_to_sample=2, n_hypers=4,
        noisy=True, standardize=True, burnin_steps=20, chain_length=64,
        num_mc=8, device="cpu", verbose=False, shape_bucket=8)
    with profile(activities=CPU):
        bo.initialize(8)
        bo.observe([[0.1, 0.2], [3.0, 4.0]])
        bo.recommend(50)
    recs = lu.records()
    by_id = {r["id"]: r for r in recs}
    outer = [r for r in recs if r["parent"] is None]
    assert [r["name"] for r in outer] == [
        "driver.initialize", "driver.observe", "driver.recommend"]
    assert [r["call"] for r in outer] == [outer[0]["call"] + k
                                          for k in range(3)]
    for r in recs:
        top = r
        while top["parent"] is not None:
            parent = by_id[top["parent"]]
            assert parent["start_ns"] <= top["start_ns"] <= \
                top["end_ns"] <= parent["end_ns"]
            top = parent
        assert r["call"] == top["call"]

    def under(name):
        return sorted(r["name"] for r in recs
                      if r["parent"] is not None and
                      by_id[r["parent"]]["name"] == name)
    assert under("driver.initialize") == ["driver.evaluate", "model.train"]
    assert under("driver.observe") == ["driver.evaluate", "model.fit",
                                       "model.train"]
    assert under("model.train") == ["model.burn_in", "model.chain",
                                     "model.chain", "model.fit",
                                     "model.fit"]
    assert under("driver.recommend") == ["optimizers.grid",
                                         "optimizers.polish"]
    polish = next(r for r in recs if r["name"] == "optimizers.polish")
    assert polish["counters"]["optimizers.gd_steps"] == \
        tbo.DEFAULT_SGD_PARAMS_RECOMMEND.max_num_steps
    assert polish["counters"]["programs.replays"] == \
        tbo.DEFAULT_SGD_PARAMS_RECOMMEND.max_num_steps


class _Bare:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_no_profiler_no_record_and_cheap(monkeypatch):
    """With no profiler running a span opens no ``record_function`` and
    keeps no record, only its aggregate; it costs under 2 us beyond a
    ``with`` statement's own (the least of several repeats, in the
    thread's CPU time)."""
    def refuse(*args, **kwargs):
        raise AssertionError("record_function with no profiler running")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    before = lu.aggregate().get("test.quiet", {"count": 0})["count"]
    with lu.span("test.quiet") as timed:
        time.sleep(0.001)
    assert lu.records() == []
    assert timed.seconds >= 0.001
    agg = lu.aggregate()["test.quiet"]
    assert agg["count"] == before + 1 and agg["max"] >= timed.seconds
    monkeypatch.undo()

    def cost(stmt, names):
        n = 20000
        return min(timeit.repeat(stmt, globals=names, number=n, repeat=7,
                                 timer=time.thread_time)) / n
    spanned = cost("with span('test.cost'): pass", {"span": lu.span})
    bare = cost("with Bare(): pass", {"Bare": _Bare})
    assert spanned - bare < 2e-6, (spanned, bare)


def test_spans_share_the_profiler_clock():
    """Under a CPU profiler each span is the event ``cmoe.<name>``, and its
    record lies inside that event, within 100 us of each end."""
    for _ in range(3):
        lu.clear_records()
        with profile(activities=CPU) as prof:
            with lu.span("test.warm"):
                pass
            with lu.span("test.outer", stage=1):
                with lu.span("test.inner"):
                    torch.ones(64).sum()
        events = {ev["name"]: ev for ev in trace_mod.profiler_events(prof)
                  if ev["name"].startswith("cmoe.test.")}
        recs = {r["name"]: r for r in lu.records()}
        assert set(events) == {"cmoe." + n for n in recs} == {
            "cmoe.test.warm", "cmoe.test.outer", "cmoe.test.inner"}
        assert recs["test.outer"]["attrs"] == {"stage": 1}
        assert recs["test.inner"]["parent"] == recs["test.outer"]["id"]
        ends = []
        for name, r in recs.items():
            ev = events["cmoe." + name]
            assert ev["start_ns"] <= r["start_ns"] <= r["end_ns"] <= \
                ev["end_ns"], name
            ends += [r["start_ns"] - ev["start_ns"],
                     ev["end_ns"] - r["end_ns"]]
        if max(ends) < 100_000:
            return
    pytest.fail(f"a record lies {max(ends)} ns from its event's end")


def test_program_replay_counts_and_records_no_span():
    """A program's call grows ``programs.replays`` (its first call
    ``programs.builds`` too) and opens no span; the growth a capture
    records of the registry is added back at each replay."""
    cache = programs.ProgramCache()
    prog = cache.get(("test_replays",), lambda t: t + 1)
    start = lu.counters()
    with profile(activities=CPU):
        for _ in range(3):
            prog(torch.zeros(2))
    assert lu.records() == []
    now = lu.counters()
    assert now["programs.replays"] - start.get("programs.replays", 0) == 3
    assert now["programs.builds"] - start.get("programs.builds", 0) == 1
    assert prog.replays == 3

    # a capture's accounting (``Program._capture_graph``), then two
    # replays adding its growth (``Program.__call__``)
    before = lu.counters()
    lu.count("optimizers.gd_steps", 2)
    lu.count("kernels.lml_fused")
    growth = lu.growth(before)
    lu.restore_counters(before)
    assert lu.counters() == before
    for _ in range(2):
        for name, n in growth.items():
            lu.count(name, n)
    assert lu.growth(before) == {"optimizers.gd_steps": 4,
                                 "kernels.lml_fused": 2}


def test_span_during_capture_is_a_no_op():
    before = lu.aggregate().get("test.captured")
    with profile(activities=CPU) as prof:
        with lu.capturing():
            with lu.span("test.captured") as timed:
                torch.ones(4).sum()
        with lu.span("test.after"):
            pass
    assert timed.seconds == 0.0
    assert lu.aggregate().get("test.captured") == before
    assert [r["name"] for r in lu.records()] == ["test.after"]
    assert not any(ev["name"] == "cmoe.test.captured"
                   for ev in trace_mod.profiler_events(prof))


def test_phase_timer_is_a_span():
    timer = lu.PhaseTimer()
    with profile(activities=CPU):
        with timer.phase("test_phase", method="KG") as found:
            found["extra"] = 2
    (rec,) = lu.records()
    assert rec["name"] == "run.test_phase"
    assert timer.records == [{"phase": "test_phase",
                              "seconds": timer.records[0]["seconds"],
                              "method": "KG", "extra": 2}]
    assert timer.records[0]["seconds"] > 0


@pytest.mark.parametrize("with_programs", [False, True])
def test_gd_steps_count_the_schedule(monkeypatch, with_programs):
    """A small polish counts one ``optimizers.gd_steps`` per step its
    schedule takes, eagerly and through a program per step."""
    rng = np.random.default_rng(0)
    made = []

    class Counting(topt._Schedule):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)
    monkeypatch.setattr(topt, "_Schedule", Counting)
    x = rng.random((12, 2))
    y = np.sin(3 * x[:, 0]) + x[:, 1]
    t = torch.float64
    states = tmcmc.fit_gp_ensemble(
        "matern_2.5", torch.tensor([[1.0, 0.5, 0.5], [1.2, 0.4, 0.6]],
                                   dtype=t),
        torch.full((2, 1), 1e-3, dtype=t), x, y)
    domain = TensorProductDomain.from_bounds([[0.0, 1.0]] * 2, dtype=t)
    params = topt.GradientDescentParameters(
        num_multistarts=1, max_num_steps=7, max_num_restarts=2,
        num_steps_averaged=3, gamma=0.7, pre_mult=1.0,
        max_relative_change=0.02, tolerance=1e-10)
    guesses = torch.as_tensor(rng.random((20, 2)), dtype=t)
    cache = programs.ProgramCache() if with_programs else None
    with profile(activities=CPU):
        tbo.recommend_from_guesses(states, domain, guesses, params,
                                   program_cache=cache)
    (polish,) = [r for r in lu.records() if r["name"] == "optimizers.polish"]
    assert polish["counters"]["optimizers.gd_steps"] == \
        sum(s.steps_taken for s in made) == 14
    assert polish["counters"].get("programs.replays", 0) == \
        (14 if with_programs else 0)


def test_launch_counts_are_views_of_the_registry():
    """A kernel's launches are the registry's counter ``kernels.<name>``:
    a span's record holds the same growth of them as a reader of a
    snapshot, and a snapshot taken after reads no growth."""
    before = lu.counters()
    with profile(activities=CPU):
        with lu.span("test.launches"):
            lu.count("kernels.descent_run", 2)
            lu.count("kernels.lml_fused", 3)
    (rec,) = [r for r in lu.records() if r["name"] == "test.launches"]
    assert rec["counters"] == lu.growth(before) == {
        "kernels.descent_run": 2, "kernels.lml_fused": 3}
    assert lu.counters()["kernels.descent_run"] == \
        before.get("kernels.descent_run", 0) + 2
    assert lu.growth(lu.counters()) == {}


def test_scale_out_recording_counts_calls_by_shape_in_the_registry():
    """``tools.scale_out.recording`` counts the recorded wrappers' calls by
    shape in the registry, under its prefix for each wrapper, and yields
    them by shape when the block ends; CPU tensors take the plain
    versions, which launch nothing."""
    g = torch.Generator().manual_seed(0)
    s, b, d, m, q, np_ = 1, 2, 2, 4, 1, 10
    us = (torch.rand(np_, d, generator=g).T / 0.5)[None].contiguous()
    noise, y = torch.full((1, np_), 1e-2), torch.ones(1, np_)
    desc = (torch.rand(s, b, d, m, generator=g), us,
            torch.rand(s, b, (1 + q) * (1 + d), np_, generator=g),
            torch.rand(s, b, q, m, generator=g), torch.rand(q, m, generator=g),
            torch.rand(s, b, q, d, generator=g),
            torch.tensor([[[0.0, 0.0], [1.0, 1.0], [1.0, 1.0]]]), "matern_2.5")
    wrappers = kernels.descent_run, kernels.lml_fused
    before = lu.counters()
    with scale_out.recording() as (shapes, lml_shapes):
        for _ in range(2):
            kernels.lml_fused(us, torch.ones(1), noise, y, np_)
        kernels.lml_fused(us.expand(3, -1, -1).contiguous(), torch.ones(3),
                          noise.expand(3, -1), y.expand(3, -1), np_)
        for steps, restarts in ((2, 3), (2, 3), (1, 1)):
            kernels.descent_run(*desc, steps=steps, restarts=restarts,
                                avg_n=1, gamma=0.0, pre_mult=1.0, mrc=0.1)
    assert (kernels.descent_run, kernels.lml_fused) == wrappers
    assert lml_shapes == {"W1_Np10": 2, "W3_Np10": 1}
    assert shapes == {"S1_B2_M4_steps6": 2, "S1_B2_M4_steps1": 1}
    assert lu.growth(before) == {
        "scale_out.lml_fused.W1_Np10": 2, "scale_out.lml_fused.W3_Np10": 1,
        "scale_out.descent_run.S1_B2_M4_steps6": 2,
        "scale_out.descent_run.S1_B2_M4_steps1": 1}


# --- the benchmark's readers ------------------------------------------------

def _trace(spans):
    """A window 0-1000 ns, the card busy in 100-200 and 300-400."""
    return trace_mod.Trace(busy=[(100, 200), (300, 400)], op_seconds={},
                           spans=[("window", 0, 1000)] + spans,
                           window=(0, 1000))


def _run(trace, traced=2):
    return SimpleNamespace(trace=trace, traced=[{}] * traced,
                           iterations=[{}] * traced, cfg={})


RECORDS = [
    {"name": "optimizers.polish", "id": 2, "parent": 1, "call": 1,
     "counters": {"optimizers.gd_steps": 3, "programs.replays": 3}},
    {"name": "driver.recommend", "id": 1, "parent": None, "call": 1,
     "counters": {"optimizers.gd_steps": 3, "programs.replays": 4}},
    {"name": "optimizers.polish", "id": 4, "parent": 3, "call": 2,
     "counters": {"optimizers.gd_steps": 1, "programs.replays": 1}},
    {"name": "driver.observe", "id": 3, "parent": None, "call": 2,
     "counters": {"optimizers.gd_steps": 1, "programs.replays": 16}},
]
AGGREGATE = {"programs.capture": {"count": 2, "total": 1.5, "max": 1.0}}
SPANS = [("model.chain", 50, 450), ("optimizers.polish", 500, 900),
         ("optimizers.polish", 920, 1000)]


@pytest.mark.parametrize("name, value", [
    # idle 50-100, 200-300, 400-450 of the chain's 400 ns
    ("chain_idle_pct", 50.0),
    # 480 ns of polish over 4 steps
    ("polish_step_us", 0.12),
    # 4 + 16 replays in the outermost spans over 2 iterations
    ("program_replays", 10.0),
    ("capture_s", 1.5),
])
def test_readers_on_a_synthetic_trace(monkeypatch, name, value):
    monkeypatch.setattr(lu, "records", lambda: list(RECORDS))
    monkeypatch.setattr(lu, "aggregate", lambda: dict(AGGREGATE))
    mod = reader(name)
    assert mod.read(_run(_trace(SPANS))) == pytest.approx(value)
    # the port's spans and records absent
    monkeypatch.setattr(lu, "records", lambda: [])
    monkeypatch.setattr(lu, "aggregate", lambda: {})
    assert mod.read(_run(_trace([]))) is None
    # a port that keeps no records nor aggregate (the parent's)
    monkeypatch.delattr(lu, "records")
    monkeypatch.delattr(lu, "aggregate")
    assert mod.read(_run(_trace([]))) is None


@pytest.mark.cuda
def test_capture_is_one_span_on_the_card():
    """On the card a program's first call is one ``programs.capture``
    span, with no span inside it, and its replays none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")

    def fn(t):
        with lu.span("test.inside"):
            return t * 2 + 1
    cache = programs.ProgramCache()
    prog = cache.get(("test_capture",), fn)
    x = torch.ones(8, device="cuda")
    with profile(activities=CPU + [ProfilerActivity.CUDA]):
        for _ in range(3):
            out = prog(x)
        torch.cuda.synchronize()
    cache.release()
    recs = lu.records()
    assert [(r["name"], r["attrs"]) for r in recs] == [
        ("programs.capture", {"kind": "test_capture"})]
    assert prog.capture_seconds == pytest.approx(
        (recs[0]["end_ns"] - recs[0]["start_ns"]) * 1e-9, abs=1e-3)
    assert torch.equal(out, x * 2 + 1) and prog.replays == 3
