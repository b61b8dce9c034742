"""The port's convert.py: JAX GP states and MCMC walkers carried across as
numpy arrays compute what the JAX package computes.

Tolerance: rtol 1e-9 / atol 1e-10 on posterior means, rtol 1e-8 / atol
1e-10 on posterior covariances (tests/test_gp.py:31-32); arrays carried
through exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cornell_moe_tpu.models import gp as jgp
from cornell_moe_tpu.models import mcmc as jmcmc
from cornell_moe_tpu_torch import convert
from cornell_moe_tpu_torch.models import gp as tgp
from cornell_moe_tpu_torch.models import mcmc as tmcmc
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
