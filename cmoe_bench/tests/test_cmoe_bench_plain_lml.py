"""The reader of the plain log marginal likelihood's counter,
``plain_lml_evals``, on a hand-built run: what it reads from the port's
records of ``driver.observe``, and nothing where the port keeps no such
counter or no records."""

import pytest

from cmoe_bench import run
from cornell_moe_tpu_torch.utils import logging_utils as lu

CFG = {"kernel_name": "matern_2.5", "dtype": "float64",
       "observations": [0, 1]}
ITERATION = {"walkers": 16, "chain_steps": 1000, "padded_n": 512,
             "cycle": 0}
EVALS = 16 * (1000 + 1)


def hand_run(traced=2):
    """``traced`` iterations, all of the traced cycle."""
    its = [dict(ITERATION) for _ in range(traced)]
    return run.Run(CFG, 2, its, 0, None, its, True)


def records(growth, name="driver.observe", counter="model.lml_plain"):
    out = []
    for i, g in enumerate(growth):
        out += [{"name": "model.chain", "id": 3 * i + 2, "parent": 3 * i + 1,
                 "call": 2 * i + 1, "counters": {counter: g}},
                {"name": name, "id": 3 * i + 1, "parent": None,
                 "call": 2 * i + 1,
                 "counters": {counter: g, "programs.replays": 17}},
                {"name": "driver.recommend", "id": 3 * i + 3,
                 "parent": None, "call": 2 * i + 2,
                 "counters": {"programs.replays": 1003}}]
    return out


@pytest.mark.parametrize("growth, value", [
    ([EVALS, EVALS], EVALS),
    ([EVALS, EVALS + 4], EVALS + 2),
])
def test_evals_per_traced_iteration(monkeypatch, growth, value):
    monkeypatch.setattr(lu, "records", lambda: records(growth))
    assert run.metric_reader("plain_lml_evals").read(hand_run()) == value


@pytest.mark.parametrize("case", ["no_counter", "no_growth", "no_records",
                                  "other_span", "parent_port"])
def test_nothing_without_the_counter(monkeypatch, case):
    """The parent's port keeps records but no ``model.lml_plain``; a port
    before the tracer keeps no records at all.  Never 0."""
    recs = {"no_counter": records([EVALS] * 2, counter="kernels.lml_fused"),
            "no_growth": records([0, 0]), "no_records": [],
            "other_span": records([EVALS] * 2, name="driver.suggest")}
    if case == "parent_port":
        monkeypatch.delattr(lu, "records")
    else:
        monkeypatch.setattr(lu, "records", lambda: recs[case])
    assert run.metric_reader("plain_lml_evals").read(hand_run()) is None

