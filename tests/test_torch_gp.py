"""Parity of the port's models/gp.py (fit, posterior mean and variance,
ensemble fit) with the JAX package, in float64.

Tolerances: rtol 1e-9 / atol 1e-10 for fitted factors and posterior means
and rtol 1e-8 / atol 1e-10 for posterior covariances (tests/test_gp.py:31-32).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cornell_moe_tpu.models import covariance as jcov
from cornell_moe_tpu.models import gp as jgp
from cornell_moe_tpu.models import mcmc as jmcmc
from cornell_moe_tpu_torch.models import covariance as tcov
from cornell_moe_tpu_torch.models import gp as tgp
from cornell_moe_tpu_torch.models import mcmc as tmcmc

torch.set_num_threads(1)
MEAN_TOL = dict(rtol=1e-9, atol=1e-10)
COV_TOL = dict(rtol=1e-8, atol=1e-10)


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


@pytest.fixture
def data(rng):
    x = rng.random((14, 2))
    y = np.sin(3 * x[:, 0]) + x[:, 1] ** 2
    return x, y[:, None], rng.random((5, 2))


@pytest.mark.parametrize("kernel", ["square_exponential", "matern_2.5"])
def test_fit_and_posterior_match_jax(kernel, data):
    x, y, xt = data
    hypers = np.array([1.1, 0.4, 0.6])
    t_state = tgp.fit_gp(tcov.make_covariance(kernel, _t(hypers)),
                         _t([1e-3]), _t(x), _t(y))
    j_state = jgp.fit_gp(jcov.make_covariance(kernel, hypers),
                         jnp.asarray([1e-3]), jnp.asarray(x), jnp.asarray(y))
    for name in ("chol_K", "K_inv_y", "inv_chol_K", "mean"):
        np.testing.assert_allclose(getattr(t_state, name).numpy(),
                                   np.asarray(getattr(j_state, name)),
                                   **MEAN_TOL)
    np.testing.assert_allclose(
        tgp.posterior_mean(t_state, _t(xt)).numpy(),
        np.asarray(jgp.posterior_mean(j_state, jnp.asarray(xt))),
        **MEAN_TOL)
    np.testing.assert_allclose(
        tgp.posterior_variance(t_state, _t(xt)).numpy(),
        np.asarray(jgp.posterior_variance(j_state, jnp.asarray(xt))),
        **COV_TOL)
    np.testing.assert_allclose(
        tgp.posterior_covariance(t_state, _t(xt[:2]), _t(xt)).numpy(),
        np.asarray(jgp.posterior_covariance(j_state, jnp.asarray(xt[:2]),
                                            jnp.asarray(xt))), **COV_TOL)


def test_ensemble_fit_with_bucket_matches_jax(data, rng):
    """fit_gp_ensemble with shape-bucket padding (PAD_NOISE rows) against
    the JAX stacked ensemble, member by member."""
    x, y, xt = data
    hypers = np.concatenate([0.8 + rng.random((3, 1)),
                             0.3 + 0.4 * rng.random((3, 2))], axis=1)
    noises = np.full((3, 1), 1e-2)
    t_states = tmcmc.fit_gp_ensemble("matern_2.5", _t(hypers), _t(noises),
                                     x, y, bucket=8)
    j_states = jmcmc.fit_gp_ensemble("matern_2.5", jnp.asarray(hypers),
                                     jnp.asarray(noises), x, y, bucket=8)
    assert t_states.chol_K.shape == (3, 16, 16)
    for name in ("chol_K", "K_inv_y", "inv_chol_K", "mean", "point_noise",
                 "points_sampled"):
        np.testing.assert_allclose(getattr(t_states, name).numpy(),
                                   np.asarray(getattr(j_states, name)),
                                   **MEAN_TOL)
    mu_t = tgp.posterior_mean(t_states, _t(xt)).numpy()
    var_t = tgp.posterior_variance(t_states, _t(xt)).numpy()
    for i in range(3):
        member = jmcmc.ensemble_member(j_states, i)
        np.testing.assert_allclose(
            mu_t[i], np.asarray(jgp.posterior_mean(member, jnp.asarray(xt))),
            **MEAN_TOL)
        np.testing.assert_allclose(
            var_t[i],
            np.asarray(jgp.posterior_variance(member, jnp.asarray(xt))),
            **COV_TOL)
    one = t_states.member(1)
    np.testing.assert_allclose(tgp.posterior_mean(one, _t(xt)).numpy(),
                               mu_t[1], **MEAN_TOL)
