"""The harness beyond the value-only Branin cell: the frozen objectives
against the port's, the reference's derivative blocks against autograd,
the roofline's count over channels, the guard against configurations the
harness cannot judge, and a toy d-KG cell (Branin with both partials
observed, 20 observations) end to end on the CPU, correct when sound and
not correct under each fault that its derivative channels can have."""

import time
from pathlib import Path

import numpy as np
import pytest
import torch

from cmoe_bench import objectives, roofline, run
from cmoe_bench.loop import Loop
from cmoe_bench.reference import gp as ref
from cmoe_bench.tests.test_cmoe_bench_harness import toy_cell
from cornell_moe_tpu_torch.models import covariance as cov_mod
from cornell_moe_tpu_torch.models import gp as gp_mod
from cornell_moe_tpu_torch.models import likelihood as lik_mod
from cornell_moe_tpu_torch.models import mcmc
from cornell_moe_tpu_torch.utils import synthetic_functions

TOY_DKG = Path(__file__).resolve().parent / "toy-dkg.json"
SEEDS = [2 ** 31 + 4241, 6 * 10 ** 9 + 11]


def dkg_cell(**cfg):
    """The toy d-KG cell, with the refit mix's own 10,000 guesses: with
    20 points and three channels the mean's least value often lies on the
    domain's edge, which 1,000 guesses miss."""
    spec = toy_cell(toy=TOY_DKG, recommend_points=None)
    return spec._replace(cfg=dict(spec.cfg, **cfg))


def run_dkg(seed=SEEDS[0], **cfg):
    return run.run_cell(dkg_cell(**cfg), seed, 1.0, False, "cpu",
                        start=time.perf_counter())


@pytest.mark.parametrize("name", sorted(objectives.OBJECTIVES))
def test_frozen_objective_matches_the_port(name):
    port = synthetic_functions.SYNTHETIC_FUNCTIONS[name]()
    mine = objectives.Objective(
        name, list(port._observations), port._num_fidelity)
    assert port._sample_var == 0.0
    np.testing.assert_array_equal(mine._search_domain, port._search_domain)
    rng = np.random.default_rng(64)
    dom = port._search_domain
    for x in rng.uniform(dom[:, 0], dom[:, 1], (64, dom.shape[0])):
        want = port.evaluate_true(x)
        got = mine.evaluate(x)
        assert got.shape == want.shape == (1 + port._dim,)
        assert np.max(np.abs(got - want) /
                      np.maximum(1.0, np.abs(want))) <= 1e-12
    assert len(mine.log) == 64


def matern52_pair(x, y, amp, lengths):
    return ref.matern52(x[None], y[None], amp, lengths)[0, 0]


def test_reference_blocks_match_autograd_of_matern52():
    """First and mixed second derivatives of ``matern52``, by autograd, at
    seeded point pairs; the blocks' layout point-major."""
    g = torch.Generator().manual_seed(7)
    a = torch.rand(5, 3, generator=g, dtype=torch.float64) * 4.0
    b = torch.rand(4, 3, generator=g, dtype=torch.float64) * 4.0
    amp = torch.tensor(2.3, dtype=torch.float64)
    lengths = torch.tensor([0.7, 1.9, 1.2], dtype=torch.float64)
    da, db = (0, 2), (2, 1, 0)
    got = ref.matern52_blocks(a, b, amp, lengths, da, db)
    assert got.shape == (5 * 3, 4 * 4)
    want = torch.empty_like(got)
    for p in range(5):
        for q in range(4):
            def k(x, y):
                return matern52_pair(x, y, amp, lengths)
            gx, gy = torch.autograd.functional.jacobian(k, (a[p], b[q]))
            hxy = torch.autograd.functional.hessian(
                lambda z: k(z[:3], z[3:]), torch.cat([a[p], b[q]]))[:3, 3:]
            rows = [[k(a[p], b[q])] + [gy[j] for j in db]]
            rows += [[gx[i]] + [hxy[i, j] for j in db] for i in da]
            for u, row in enumerate(rows):
                for v, val in enumerate(row):
                    want[p * 3 + u, q * 4 + v] = val
    torch.testing.assert_close(got, want, rtol=1e-10,
                               atol=1e-10 * float(want.abs().max()))
    values = ref.matern52(a, b, amp, lengths)
    torch.testing.assert_close(ref.matern52_blocks(a, b, amp, lengths),
                               values, rtol=1e-13,
                               atol=1e-13 * float(values.abs().max()))


def test_roofline_counts_the_channels():
    one = roofline.lml_bound(8, 512, 2, "matern_2.5", "float64")
    assert roofline.lml_bound(8, 512, 2, "matern_2.5", "float64",
                              channels=1) == one
    three = roofline.lml_bound(8, 512, 2, "matern_2.5", "float64",
                               channels=3)
    assert three["pipes_ms"]["fp64_mma"] == pytest.approx(
        8 * 1536 ** 3 / 3 / roofline.FP64_MMA_FLOPS * 1e3, rel=1e-12)
    assert three["ms"] > one["ms"]
    cov1 = roofline.covariance_bound(16, 512, 2, "matern_2.5")
    assert roofline.covariance_bound(16, 512, 2, "matern_2.5",
                                     channels=1) == cov1
    cov3 = roofline.covariance_bound(16, 512, 2, "matern_2.5", channels=3)
    assert cov3["pipes_ms"]["hbm"] > 8.9 * cov1["pipes_ms"]["hbm"]


def test_objective_keeps_the_observed_channels():
    f = objectives.Objective("BraninWithDerivatives", [1, 0], 0)
    assert f._observations == (1, 0)
    assert f.channels == [0, 2, 1]
    out = f.evaluate([1.0, 2.0])
    assert out.shape == (3,)
    np.testing.assert_array_equal(f.log[0][1], out)


@pytest.mark.parametrize("change", [
    {"objective": "Branin3000"},
    {"kernel_name": "square_exponential"},
    {"num_fidelity": 1},
    {"observations": [0, 2]},
    {"noisy": False},
    {"standardize": False},
], ids=["objective", "kernel_name", "num_fidelity", "observations", "noisy",
        "standardize"])
def test_configuration_the_harness_cannot_judge_fails_before_set_up(
        monkeypatch, change):
    def no_set_up(*args, **kwargs):
        raise AssertionError("set-up began")
    monkeypatch.setattr(run, "Loop", no_set_up)
    with pytest.raises(run.Fail):
        run_dkg(**change)


@pytest.mark.parametrize("seed", SEEDS)
def test_toy_dkg_cell_end_to_end_is_correct(seed):
    result, extra = run_dkg(seed)
    assert result["correct"] is True, result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert all(np.isfinite(v) for v in extra["readings"].values())


def test_toy_cell_with_a_fidelity_dimension_is_correct():
    """Branin with its fidelity (cf-KG's objective): the reference's
    recommendation over the first two coordinates, the fidelity at 1."""
    spec = toy_cell(recommend_points=None)
    spec = spec._replace(cfg=dict(spec.cfg, objective="BraninFidelity",
                                  num_fidelity=1))
    result, extra = run.run_cell(spec, SEEDS[1], 1.0, False, "cpu",
                                 start=time.perf_counter())
    assert result["correct"] is True, result["checks"]
    assert extra["readings"]["rec_gap"] < 1e-3


def test_toy_dkg_records_every_channel(monkeypatch):
    kept = {}
    real = Loop.close

    def close(self):
        kept["records"] = self.records
        real(self)
    monkeypatch.setattr(Loop, "close", close)
    run_dkg()
    rec = kept["records"][0]
    n = rec["points"].shape[0]
    assert rec["values"].shape == (n, 3)
    np.testing.assert_array_equal(rec["held_values"], rec["values"])
    assert rec["alpha"].shape[-1] == 3 * rec["held_points"].shape[0]


@pytest.mark.parametrize("where", ["to_the_driver", "to_the_reference"])
def test_gradient_channel_left_out_of_what_the_harness_hands_over(
        monkeypatch, where):
    """The last partial left out: the driver gets 0 in its place while the
    harness logs it, or the harness's record of the data lacks it."""
    if where == "to_the_driver":
        real = objectives.Objective.evaluate

        def evaluate(self, x):
            out = real(self, x).copy()
            out[-1] = 0.0
            return out
        monkeypatch.setattr(objectives.Objective, "evaluate", evaluate)
    else:
        real = Loop.data

        def data(self):
            points, values = real(self)
            return points, values[:, :-1]
        monkeypatch.setattr(Loop, "data", data)
    result, _ = run_dkg()
    assert result["correct"] is False
    assert result["checks"]["data_mismatch"][0] > 0


def test_chain_log_posterior_on_values_only(monkeypatch):
    """The chain's LML over the value channel alone, under the value
    channel's noise; the prior over every walker coordinate."""
    def values_only(self, thetas, x, y, point_noise=None, force_plain=False):
        h = torch.exp(thetas)
        cov = cov_mod.COVARIANCE_TYPES[self.kernel_name](
            hyperparameters=h[:, :self.dim + 1])
        lml = lik_mod.log_marginal_likelihood(
            cov, h[:, self.dim + 1:self.dim + 2], x, y[:, :1], (),
            point_noise=None if point_noise is None else point_noise[:, :1])
        val = self.prior.lnprob(thetas) + lml
        inside = torch.all(torch.abs(thetas) <= mcmc.LOG_BOUND, dim=1)
        return torch.where(inside & torch.isfinite(val), val, float("-inf"))
    monkeypatch.setattr(mcmc.GaussianProcessLogLikelihoodMCMC,
                        "log_posterior", values_only)
    result, _ = run_dkg()
    assert result["correct"] is False
    value, limit = result["checks"]["chain_lml_err"]
    assert value is None or value > limit


def test_post_err_from_alpha_fitted_without_the_gradient_channels(
        monkeypatch):
    """The ensemble's K^-1 y from the value channel's system alone, 0 on
    the partials' rows; the factor the real one."""
    real = gp_mod.fit_factors

    def value_alpha(covariance, noise, x, y, point_noise, ds, **kwargs):
        chol, k_inv_y, inv_chol, mean = real(covariance, noise, x, y,
                                             point_noise, ds, **kwargs)
        if ds:
            alone = real(covariance, noise[..., :1], x, y[:, :1],
                         None if point_noise is None else point_noise[:, :1],
                         (), **kwargs)[1]
            full = torch.zeros(alone.shape + (1 + len(ds),),
                               dtype=alone.dtype, device=alone.device)
            full[..., 0] = alone
            k_inv_y = full.reshape(k_inv_y.shape)
        return chol, k_inv_y, inv_chol, mean
    monkeypatch.setattr(gp_mod, "fit_factors", value_alpha)
    result, _ = run_dkg()
    assert result["correct"] is False
    value, limit = result["checks"]["post_err"]
    assert value is None or value > limit
