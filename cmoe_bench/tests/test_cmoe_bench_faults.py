"""The comparison that decides ``correct`` sees each fault that a cell of
this benchmark can have: a toy cell driven through the harness on the
CPU with the timed path broken underneath (the retrain leaving the data
as it was, a chain that leaves its walkers where they were, a log
posterior scaled or shifted where the chain computes it, half of the
observed batch left out, the recommendation altered where it is
produced) comes out not correct; and so does the control on the card,
the port's own float32 path in the program's place, held to the same
limits.  There is no exchange between chips: every cell takes one."""

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from cmoe_bench import run
from cmoe_bench.tests.test_cmoe_bench_harness import toy_cell
from cornell_moe_tpu_torch import bayes_opt
from cornell_moe_tpu_torch.models import mcmc

SEED = 2 ** 31 + 977
ROOT = Path(__file__).resolve().parents[2]


def run_toy():
    return run.run_cell(toy_cell(), SEED, 1.0, False, "cpu",
                        start=time.perf_counter())


def test_sound_toy_run_is_correct():
    result, _ = run_toy()
    assert result["correct"] is True, result["checks"]


def test_retrain_that_leaves_the_state_unchanged(monkeypatch):
    monkeypatch.setattr(mcmc.GaussianProcessLogLikelihoodMCMC,
                        "add_sampled_points", lambda self, pts: None)
    result, _ = run_toy()
    assert result["correct"] is False
    assert result["checks"]["data_mismatch"][0] > 0


def test_chain_that_leaves_its_walkers_where_they_were(monkeypatch):
    def frozen(generator, log_prob_fn, p0, steps, *args, **kwargs):
        return p0, log_prob_fn(p0)
    monkeypatch.setattr(mcmc, "run_ensemble_mcmc", frozen)
    result, _ = run_toy()
    assert result["correct"] is False
    assert result["checks"]["walkers_unmoved"][0] > 0


@pytest.mark.parametrize("scale, shift", [(1.5, 0.0), (1.0, 150.0)])
def test_log_posterior_wrong_where_the_chain_computes_it(monkeypatch, scale,
                                                         shift):
    """The LML the chain samples under, scaled or shifted (the prior left
    as it is)."""
    real = mcmc.GaussianProcessLogLikelihoodMCMC.log_posterior

    def wrong(self, thetas, *args, **kwargs):
        prior = self.prior.lnprob(thetas)
        return prior + scale * (real(self, thetas, *args, **kwargs) -
                                prior) + shift
    monkeypatch.setattr(mcmc.GaussianProcessLogLikelihoodMCMC,
                        "log_posterior", wrong)
    result, _ = run_toy()
    assert result["correct"] is False
    assert result["checks"]["chain_lml_err"][0] > \
        result["checks"]["chain_lml_err"][1]


def test_half_of_the_batch_left_out(monkeypatch):
    real = mcmc.GaussianProcessLogLikelihoodMCMC.add_sampled_points

    def half(self, pts):
        pts = list(pts)
        return real(self, pts[:len(pts) // 2])
    monkeypatch.setattr(mcmc.GaussianProcessLogLikelihoodMCMC,
                        "add_sampled_points", half)
    result, _ = run_toy()
    assert result["correct"] is False
    assert result["checks"]["data_mismatch"][0] > 0


def test_recommendation_altered_where_it_is_produced(monkeypatch):
    """The answer the cell compares besides its data."""
    real = bayes_opt.BayesianOptimizer.recommend

    def moved(self, num_eval_pts=10000):
        rec = real(self, num_eval_pts)
        lo, hi = self.domain.bounds[:, 0].cpu().numpy(), \
            self.domain.bounds[:, 1].cpu().numpy()
        return np.clip(rec + 0.2 * (hi - lo), lo, hi)
    monkeypatch.setattr(bayes_opt.BayesianOptimizer, "recommend", moved)
    result, _ = run_toy()
    assert result["correct"] is False
    assert result["checks"]["rec_gap"][0] > result["checks"]["rec_gap"][1]


@pytest.mark.cuda
def test_control_comes_out_not_correct_on_the_card():
    """The port's float32 path in place of the float64 cell's, at the
    cell's own size with a short window."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, "-m", "cmoe_bench.control", "--workload",
         "qkg-branin-f64.refit", "--seconds", "4", "--seeds",
         str(2 ** 33 + 17)], cwd=ROOT, capture_output=True, text=True,
        timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is False
    assert any(v is None or v > limit
               for v, limit in line["checks"].values())
