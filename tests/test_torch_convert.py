"""The port's convert.py: JAX GP states, MCMC walkers, random-feature
samples and PES-state inputs carried across as numpy arrays compute what
the JAX package computes.

Tolerance: rtol 1e-9 / atol 1e-10 on posterior means, rtol 1e-8 / atol
1e-10 on posterior covariances (tests/test_gp.py:31-32); a carried
random-feature sample's values at rtol 1e-12; the PES state built from
carried inputs at rtol 1e-8 / atol 1e-10 (tests/test_pes.py:220, as
tests/test_torch_pes.py holds EP); a carried compat model's posterior
mean and its EI on carried normals at rtol 1e-10 (as
tests/test_torch_compat.py holds the compat classes); arrays carried
through exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cornell_moe_tpu.acquisition import pes as jpes
from cornell_moe_tpu.models import covariance as jcov
from cornell_moe_tpu.models import gp as jgp
from cornell_moe_tpu.models import mcmc as jmcmc
from cornell_moe_tpu.ops import random_features as jrf
from cornell_moe_tpu_torch import convert
from cornell_moe_tpu_torch.models import gp as tgp
from cornell_moe_tpu_torch.models import mcmc as tmcmc
from cornell_moe_tpu_torch.ops import random_features as trf
from cornell_moe_tpu_torch.utils.data_containers import HistoricalData

torch.set_num_threads(1)


def _arrays(state):
    out = {"hyperparameters": np.asarray(state.covariance.hyperparameters)}
    for name in convert.GP_STATE_FIELDS[1:]:
        v = getattr(state, name)
        out[name] = None if v is None else np.asarray(v)
    return out


@pytest.mark.parametrize("stacked", [False, True])
def test_gp_state_carries_posterior(rng, stacked):
    x = rng.random((13, 2))
    y = np.sin(3 * x[:, 0])[:, None]
    hypers = np.array([[1.1, 0.4, 0.6], [0.7, 0.3, 0.5]])
    j = jmcmc.fit_gp_ensemble("matern_2.5", jnp.asarray(hypers),
                              jnp.asarray([[1e-2], [2e-2]]), x, y, bucket=8)
    if not stacked:
        j = jmcmc.ensemble_member(j, 1)
    arrays = _arrays(j)
    t = convert.gp_state_from_arrays(arrays, "matern_2.5")
    xt = rng.random((4, 2))
    mu = tgp.posterior_mean(t, torch.as_tensor(xt)).numpy()
    var = tgp.posterior_variance(t, torch.as_tensor(xt)).numpy()
    members = [jmcmc.ensemble_member(j, i) for i in range(2)] if stacked \
        else [j]
    for i, member in enumerate(members):
        np.testing.assert_allclose(
            mu[i] if stacked else mu,
            np.asarray(jgp.posterior_mean(member, jnp.asarray(xt))),
            rtol=1e-9, atol=1e-10)
        np.testing.assert_allclose(
            var[i] if stacked else var,
            np.asarray(jgp.posterior_variance(member, jnp.asarray(xt))),
            rtol=1e-8, atol=1e-10)
    back = convert.gp_state_to_arrays(t)
    for name, value in arrays.items():
        np.testing.assert_array_equal(back[name], value)


def test_mcmc_walkers_carried(rng):
    x = rng.random((9, 2))
    y = np.sin(3 * x[:, 0])
    p0 = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (16, 4)))
    picks = p0[::2] * 0.5
    data = HistoricalData(2)
    data.append_historical_data(x, y)
    model = tmcmc.GaussianProcessLogLikelihoodMCMC(
        data, device="cpu", dtype=torch.float64,
        generator=torch.Generator().manual_seed(0))
    convert.set_mcmc_walkers(model, p0, picks)
    assert model.burned
    np.testing.assert_array_equal(model.p0.numpy(), p0)
    model._finalize_models()
    np.testing.assert_allclose(
        model.models.covariance.hyperparameters.numpy(),
        np.exp(picks[:, :3]), rtol=1e-15)


@pytest.mark.parametrize("stacked", [False, True])
def test_random_feature_sample_carried(rng, stacked):
    """A JAX random-feature sample (one, or three stacked by vmap) carried
    across evaluates to the JAX package's values."""
    x = rng.random((7, 2))
    state = jgp.fit_gp(jcov.make_covariance("matern_2.5", [1.2, 0.5, 0.7]),
                       jnp.asarray([1e-3]), jnp.asarray(x),
                       jnp.asarray(np.sin(3 * x[:, :1])))
    keys = jax.random.split(jax.random.PRNGKey(4), 3)
    draw = jax.jit(lambda k: jrf.sample_gp_with_random_features(k, state,
                                                                  50))
    sample = jax.vmap(draw)(keys) if stacked else draw(keys[0])
    got = convert.random_feature_sample_from_arrays(
        {name: np.asarray(v) for name, v in sample._asdict().items()})
    pts = rng.random((6, 2))
    ref = jax.jit(jax.vmap(jrf.evaluate_random_feature_sample,
                           in_axes=(0, None)) if stacked else
                  jrf.evaluate_random_feature_sample)(sample, jnp.asarray(pts))
    vals = trf.evaluate_random_feature_sample(got, torch.as_tensor(pts))
    assert vals.shape == ((3, 6) if stacked else (6,))
    np.testing.assert_allclose(vals.numpy(), np.asarray(ref), rtol=1e-12)


def test_pes_state_from_carried_inputs(rng):
    """make_pes_state's inputs for two sets carried across give the JAX
    package's PES state, set by set."""
    x, y = rng.random((6, 2)), rng.standard_normal(6)
    a = rng.standard_normal((2, 2, 2))
    arrays = {"x_samples": x, "y": y, "x_min": rng.random((2, 2)),
              "hess_at_min": a @ a.transpose(0, 2, 1) + 2 * np.eye(2),
              "sigma": np.array([1.2, 0.9]),
              "lengths": 0.4 + 0.3 * rng.random((2, 2)),
              "noise": np.array([1e-3, 2e-3])}
    got = convert.pes_state_from_arrays(arrays)
    for i in range(2):
        ref = jax.jit(jpes.make_pes_state)(*[
            jnp.asarray(arrays[n] if n in ("x_samples", "y") else
                        arrays[n][i]) for n in convert.PES_STATE_INPUTS])
        for name in ref._fields:
            np.testing.assert_allclose(getattr(got, name)[i].numpy(),
                                       np.asarray(getattr(ref, name)),
                                       rtol=1e-8, atol=1e-10, err_msg=name)


@pytest.mark.parametrize("model", ["gaussian_process", "ensemble"])
def test_compat_model_and_draws_carried(rng, model):
    """A JAX compat GaussianProcess (or GaussianProcessMCMC), its MC-EI
    object's normals and a multistart's starts carried across: the port's
    objects give the JAX package's posterior mean and EI."""
    from cornell_moe_tpu.compat import covariance as jcov_c
    from cornell_moe_tpu.compat import expected_improvement as jei_c
    from cornell_moe_tpu.compat import expected_improvement_mcmc as jeim_c
    from cornell_moe_tpu.compat import gaussian_process as jgp_c
    from cornell_moe_tpu.compat import knowledge_gradient_mcmc as jkgm_c
    from cornell_moe_tpu.utils.data_containers import HistoricalData as JD
    from cornell_moe_tpu_torch.compat import expected_improvement as tei_c
    from cornell_moe_tpu_torch.compat import \
        expected_improvement_mcmc as teim_c

    x = rng.random((8, 2))
    data = JD(2)
    data.append_historical_data(x, np.sin(3 * x[:, 0]))
    pts = rng.random((2, 2))
    if model == "ensemble":
        j = jkgm_c.GaussianProcessMCMC([[1.1, 0.5, 0.7], [0.8, 0.4, 0.6]],
                                       [[1e-3], [2e-3]], data)
        j_ei = jeim_c.ExpectedImprovementMCMC(j, num_to_sample=2,
                                              num_mc_iterations=16)
    else:
        j = jgp_c.GaussianProcess(jcov_c.SquareExponential([1.1, 0.5, 0.7]),
                                  [1e-3], data)
        j_ei = jei_c.ExpectedImprovement(j, points_to_sample=pts,
                                         num_mc_iterations=16)
    arrays = convert.compat_model_to_arrays(j)
    t = convert.compat_model_from_arrays(arrays, device="cpu",
                                         dtype=torch.float64)
    back = convert.compat_model_to_arrays(t)
    for name, value in arrays.items():
        np.testing.assert_array_equal(np.asarray(back[name]),
                                      np.asarray(value), err_msg=name)
    if model == "ensemble":
        t_ei = teim_c.ExpectedImprovementMCMC(t, num_to_sample=2,
                                              num_mc_iterations=16)
        mu = tgp.posterior_mean(t.states, torch.as_tensor(pts)).numpy()
        for i in range(2):
            np.testing.assert_allclose(mu[i], np.asarray(jgp.posterior_mean(
                jmcmc.ensemble_member(j.states, i), jnp.asarray(pts))),
                rtol=1e-10)
    else:
        t_ei = tei_c.ExpectedImprovement(t, points_to_sample=pts,
                                         num_mc_iterations=16)
        np.testing.assert_allclose(t.compute_mean_of_points(pts),
                                   j.compute_mean_of_points(pts),
                                   rtol=1e-10)
    convert.carry_normals(t_ei, np.asarray(j_ei._normals))
    for obj in (j_ei, t_ei):
        obj.set_current_point(pts)
    np.testing.assert_allclose(t_ei.compute_objective_function(),
                               j_ei.compute_objective_function(),
                               rtol=1e-10)
    starts = np.asarray(jax.random.uniform(jax.random.PRNGKey(1), (3, 2, 2)))
    carried = convert.starts_from_array(starts)
    assert carried.dtype == torch.float64
    np.testing.assert_array_equal(carried.numpy(), starts)
