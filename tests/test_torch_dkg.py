"""Parity of the port's derivative-observation path (d-KG, d-EI) with the
JAX package, in float64, and the port's three kernel gates.

Tolerances: derivative blocks and per-channel noise at rtol 1e-12
(tests/test_covariance.py:35); fitted factors and posterior means at rtol
1e-9 / atol 1e-10, posterior covariances at rtol 1e-8 / atol 1e-10
(tests/test_gp.py:31-32); the LML and the log-posterior at rtol 1e-10
(tests/test_likelihood_mcmc.py:32); fantasy model, fantasy mean, descent
endpoints and KG values at rtol 1e-9 / atol 1e-11, union gradients at rtol
1e-7 / atol 1e-9 (tests/test_knowledge_gradient.py:50); the whole d-KG slice
at rtol 1e-7 / atol 1e-9 (as tests/test_torch_driver.py holds the q-KG
slice).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cornell_moe_tpu import bayes_opt as jbo
from cornell_moe_tpu import native
from cornell_moe_tpu.acquisition import expected_improvement as jei
from cornell_moe_tpu.acquisition import knowledge_gradient as jkg
from cornell_moe_tpu.models import covariance as jcov
from cornell_moe_tpu.models import gp as jgp
from cornell_moe_tpu.models import likelihood as jlik
from cornell_moe_tpu.models import mcmc as jmcmc
from cornell_moe_tpu.ops import optimizers as jopt
from cornell_moe_tpu.ops.domains import RepeatedDomain as JRep
from cornell_moe_tpu.ops.domains import TensorProductDomain as JDom
from cornell_moe_tpu.utils import synthetic_functions as jsf
from cornell_moe_tpu.utils.data_containers import HistoricalData as JHist
from cornell_moe_tpu_torch import bayes_opt as tbo
from cornell_moe_tpu_torch import convert
from cornell_moe_tpu_torch.acquisition import expected_improvement as tei
from cornell_moe_tpu_torch.acquisition import knowledge_gradient as tkg
from cornell_moe_tpu_torch.models import covariance as tcov
from cornell_moe_tpu_torch.models import gp as tgp
from cornell_moe_tpu_torch.models import likelihood as tlik
from cornell_moe_tpu_torch.models import mcmc as tmcmc
from cornell_moe_tpu_torch.ops import kernels
from cornell_moe_tpu_torch.ops import optimizers as topt
from cornell_moe_tpu_torch.ops.domains import RepeatedDomain as TRep
from cornell_moe_tpu_torch.ops.domains import TensorProductDomain as TDom
from cornell_moe_tpu_torch.utils import synthetic_functions as tsf
from cornell_moe_tpu_torch.utils.data_containers import HistoricalData

torch.set_num_threads(1)
F64 = torch.float64
F32 = torch.float32
COVARIANCES = ["square_exponential", "matern_2.5"]
BLOCK_TOL = dict(rtol=1e-12, atol=1e-13)
MEAN_TOL = dict(rtol=1e-9, atol=1e-10)
COV_TOL = dict(rtol=1e-8, atol=1e-10)
TOL = dict(rtol=1e-9, atol=1e-11)
GRAD = dict(rtol=1e-7, atol=1e-9)
SLICE = dict(rtol=1e-7, atol=1e-9)
DS = (0, 1)
S, B, Q, M, N = 3, 3, 2, 8, 10
INNER = dict(num_multistarts=1, max_num_steps=6, max_num_restarts=1,
             num_steps_averaged=3, gamma=0.0, pre_mult=1.0,
             max_relative_change=0.1)


def _t(a, dtype=F64):
    return torch.as_tensor(np.array(a), dtype=dtype)


def _branin_data(rng, n):
    """Branin values and both partials at n points of the unit box (the
    box's coordinates mapped onto Branin's domain), standardized as the
    model does: the value by (y - mean) / std, the partials by 1 / std."""
    x = rng.random((n, 2))
    f = tsf.Branin()
    y = np.stack([f.evaluate_true([15.0 * a, 20.0 * b - 5.0])
                  for a, b in x])
    y[:, 1] *= 15.0
    y[:, 2] *= 20.0
    mu, sd = y[:, 0].mean(), y[:, 0].std()
    y[:, 0] -= mu
    return x, y / sd


def _hypers(rng, s):
    return np.concatenate([0.8 + rng.random((s, 1)),
                           0.3 + 0.4 * rng.random((s, 2))], axis=1)


# ---------------------------------------------------------------------------
# covariance
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kernel", COVARIANCES)
@pytest.mark.parametrize("ds1, ds2", [((0, 2), (1,)), ((0, 1, 2), (0, 1, 2)),
                                      ((), (2, 0))])
def test_derivative_blocks_match_jax(kernel, ds1, ds2, rng):
    """n1 = 5, n2 = 4, d = 3: one kernel, and an ensemble of two against
    the JAX package member by member."""
    hypers = np.array([[1.3, 0.6, 1.4, 0.9], [0.7, 1.1, 0.5, 1.6]])
    x1, x2 = rng.standard_normal((5, 3)), rng.standard_normal((4, 3))
    got = tcov.build_block_covariance(
        tcov.make_covariance(kernel, _t(hypers)), _t(x1), ds1, _t(x2), ds2)
    assert got.shape == (2, 5 * (1 + len(ds1)), 4 * (1 + len(ds2)))
    for i in range(2):
        ref = jcov.build_block_covariance(
            jcov.make_covariance(kernel, hypers[i]), jnp.asarray(x1), ds1,
            jnp.asarray(x2), ds2)
        np.testing.assert_allclose(got[i].numpy(), np.asarray(ref),
                                   **BLOCK_TOL)
        one = tcov.build_block_covariance(
            tcov.make_covariance(kernel, _t(hypers[i])), _t(x1), ds1,
            _t(x2), ds2)
        np.testing.assert_allclose(one.numpy(), np.asarray(ref), **BLOCK_TOL)


@pytest.mark.parametrize("kernel", COVARIANCES)
def test_covariance_with_channel_noise_matches_jax(kernel, rng):
    """Per-channel noise (S, 1 + m) tiled over the points, plus per-point
    noise (n, 1 + m) with PAD_NOISE rows, ds (0, 2) at d = 3."""
    n, ds = 6, (0, 2)
    hypers = np.concatenate([1.0 + rng.random((2, 1)),
                             0.5 + rng.random((2, 3))], axis=1)
    x = rng.standard_normal((n, 3))
    noise = 1e-2 + 1e-2 * rng.random((2, 3))
    point_noise = np.zeros((n, 3))
    point_noise[-2:] = 1e8
    got = tcov.build_covariance_matrix_with_noise(
        tcov.make_covariance(kernel, _t(hypers)), _t(x), ds, _t(noise),
        _t(point_noise))
    assert got.shape == (2, 18, 18)
    for i in range(2):
        ref = jcov.build_covariance_matrix_with_noise(
            jcov.make_covariance(kernel, hypers[i]), jnp.asarray(x), ds,
            jnp.asarray(point_noise + noise[i]), use_pallas="never")
        np.testing.assert_allclose(got[i].numpy(), np.asarray(ref),
                                   **BLOCK_TOL)
        ref1 = jcov.build_covariance_matrix_with_noise(
            jcov.make_covariance(kernel, hypers[i]), jnp.asarray(x), ds,
            jnp.asarray(noise[i]), use_pallas="never")
        got1 = tcov.build_covariance_matrix_with_noise(
            tcov.make_covariance(kernel, _t(hypers[i])), _t(x), ds,
            _t(noise[i]))
        np.testing.assert_allclose(got1.numpy(), np.asarray(ref1),
                                   **BLOCK_TOL)


@pytest.mark.skipif(not native.available(),
                    reason="native toolchain unavailable")
@pytest.mark.parametrize("kernel", COVARIANCES)
def test_derivative_path_matches_native_oracle(kernel, rng):
    """The port's derivative blocks, posterior and LML against the C++
    oracle, at tests/test_native.py's tolerances (its :23, :70 and the
    LML's rtol 1e-11 there)."""
    dim, n, derivs = 2, 6, (0, 1)
    hypers = np.concatenate([[1.4], 0.5 + rng.random(dim)])
    x1, x2 = rng.standard_normal((4, dim)), rng.standard_normal((6, dim))
    cov = tcov.make_covariance(kernel, _t(hypers))
    np.testing.assert_allclose(
        tcov.build_block_covariance(cov, _t(x1), derivs, _t(x2),
                                    derivs).numpy(),
        native.build_block_covariance(kernel, hypers, x1, derivs, x2,
                                      derivs), rtol=1e-12, atol=1e-14)
    x = rng.standard_normal((n, dim))
    y = np.hstack([np.sin(x.sum(1))[:, None], np.cos(x)])
    noise = np.array([1e-3, 1e-3, 1e-3])
    xs = rng.standard_normal((3, dim))
    state = tgp.fit_gp(cov, _t(noise), _t(x), _t(y), derivatives=derivs)
    mu_nat, var_nat = native.gp_posterior(kernel, hypers, x, derivs, noise,
                                          y, xs)
    np.testing.assert_allclose(tgp.posterior_mean(state, _t(xs))[:, 0],
                               mu_nat, rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(tgp.posterior_variance(state, _t(xs)),
                               var_nat, rtol=1e-8, atol=1e-11)
    np.testing.assert_allclose(
        float(tlik.log_marginal_likelihood(cov, _t(noise), _t(x), _t(y),
                                           derivs)),
        native.log_marginal_likelihood(kernel, hypers, x, derivs, noise, y),
        rtol=1e-11)


# ---------------------------------------------------------------------------
# GP
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kernel", COVARIANCES)
def test_fit_and_posterior_with_derivatives_match_jax(kernel, rng):
    x, y = _branin_data(rng, 9)
    xt = rng.random((4, 2))
    hypers = np.array([1.1, 0.4, 0.6])
    noise = np.array([1e-3, 2e-3, 3e-3])
    t_state = tgp.fit_gp(tcov.make_covariance(kernel, _t(hypers)),
                         _t(noise), _t(x), _t(y), derivatives=DS)
    j_state = jgp.fit_gp(jcov.make_covariance(kernel, hypers),
                         jnp.asarray(noise), jnp.asarray(x), jnp.asarray(y),
                         derivatives=DS)
    assert t_state.derivatives == DS and t_state.chol_K.shape == (27, 27)
    for name in ("chol_K", "K_inv_y", "inv_chol_K", "mean",
                 "noise_variance"):
        np.testing.assert_allclose(getattr(t_state, name).numpy(),
                                   np.asarray(getattr(j_state, name)),
                                   **MEAN_TOL)
    for ds in ((), (1,), DS):
        np.testing.assert_allclose(
            tgp.posterior_mean(t_state, _t(xt), ds).numpy(),
            np.asarray(jgp.posterior_mean(j_state, jnp.asarray(xt), ds)),
            **MEAN_TOL)
        np.testing.assert_allclose(
            tgp.posterior_variance(t_state, _t(xt), ds).numpy(),
            np.asarray(jgp.posterior_variance(j_state, jnp.asarray(xt), ds)),
            **COV_TOL)
    np.testing.assert_allclose(
        tgp.posterior_covariance(t_state, _t(xt[:2]), _t(xt), DS).numpy(),
        np.asarray(jgp.posterior_covariance(j_state, jnp.asarray(xt[:2]),
                                            jnp.asarray(xt), DS)), **COV_TOL)


@pytest.mark.parametrize("kernel", COVARIANCES)
def test_derivative_observations_interpolate(kernel, rng):
    """Port twin of tests/test_gp.py:97: with gradient observations and
    tiny noise the posterior reproduces the observed values and partials,
    and conditioning on gradients shrinks the predictive variance."""
    dim, n = 2, 8
    hypers = np.concatenate([[1.0], 0.8 + 0.2 * rng.random(dim)])
    cov = tcov.make_covariance(kernel, _t(hypers))
    x = rng.standard_normal((n, dim))
    y = np.stack([[np.sin(p[0]) * np.cos(p[1]),
                   np.cos(p[0]) * np.cos(p[1]),
                   -np.sin(p[0]) * np.sin(p[1])] for p in x])
    state = tgp.fit_gp(cov, _t([1e-10] * 3), _t(x), _t(y), derivatives=DS)
    mu = tgp.posterior_mean(state, _t(x), DS).numpy()
    np.testing.assert_allclose(mu, y, rtol=1e-4, atol=1e-5)
    state_v = tgp.fit_gp(cov, _t([1e-10]), _t(x), _t(y[:, :1]))
    xt = _t(rng.standard_normal((5, dim)) * 0.5)
    var_with = torch.diagonal(tgp.posterior_variance(state, xt)).numpy()
    var_wo = torch.diagonal(tgp.posterior_variance(state_v, xt)).numpy()
    assert np.all(var_with <= var_wo + 1e-9)


def test_ensemble_fit_with_derivatives_and_convert_match_jax(rng):
    """fit_gp_ensemble over 3 channels with bucket padding against the JAX
    stacked ensemble; convert carries the derivative state both ways."""
    x, y = _branin_data(rng, 11)
    hypers = _hypers(rng, S)
    noises = 1e-2 * (1.0 + rng.random((S, 3)))
    t = tmcmc.fit_gp_ensemble("matern_2.5", _t(hypers), _t(noises), x, y,
                              DS, bucket=8)
    j = jmcmc.fit_gp_ensemble("matern_2.5", jnp.asarray(hypers),
                              jnp.asarray(noises), x, y, derivatives=DS,
                              bucket=8)
    assert t.chol_K.shape == (S, 48, 48)
    assert t.point_noise.shape == (S, 16, 3)
    for name in ("chol_K", "K_inv_y", "mean", "point_noise",
                 "points_sampled_value"):
        np.testing.assert_allclose(getattr(t, name).numpy(),
                                   np.asarray(getattr(j, name)), **MEAN_TOL)
    arrays = {"hyperparameters": np.asarray(j.covariance.hyperparameters),
              "derivatives": j.derivatives,
              **{k: None if getattr(j, k) is None else
                 np.asarray(getattr(j, k))
                 for k in convert.GP_STATE_FIELDS[1:]}}
    c = convert.gp_state_from_arrays(arrays, "matern_2.5")
    assert c.derivatives == DS and c.noise_variance.shape == (S, 3)
    xt = _t(rng.random((4, 2)))
    np.testing.assert_allclose(tgp.posterior_mean(c, xt, DS).numpy(),
                               tgp.posterior_mean(t, xt, DS).numpy(),
                               **MEAN_TOL)
    back = convert.gp_state_to_arrays(c)
    assert back["derivatives"] == DS
    np.testing.assert_array_equal(back["noise_variance"],
                                  arrays["noise_variance"])


# ---------------------------------------------------------------------------
# likelihood and MCMC
# ---------------------------------------------------------------------------

def test_lml_over_channels_matches_jax(rng):
    x, y = _branin_data(rng, 10)
    pn = np.zeros((10, 3))
    pn[-2:] = 1e8
    hypers = np.array([[1.2, 0.3, 0.5], [0.7, 0.6, 0.2]])
    noises = np.array([[1e-2, 2e-2, 3e-2], [3e-2, 1e-2, 5e-3]])
    got = tlik.log_marginal_likelihood(
        tcov.make_covariance("matern_2.5", _t(hypers)), _t(noises), _t(x),
        _t(y), DS, point_noise=_t(pn))
    for i in range(2):
        ref = jlik.log_marginal_likelihood(
            jcov.make_covariance("matern_2.5", hypers[i]),
            jnp.asarray(noises[i]), jnp.asarray(x), jnp.asarray(y), DS,
            point_noise=jnp.asarray(pn))
        np.testing.assert_allclose(float(got[i]), float(ref), rtol=1e-10)


def _models(rng, n=11, **kw):
    x, y = _branin_data(rng, n)
    y = 40.0 + 30.0 * y
    jdata, tdata = JHist(dim=2, num_derivatives=2), \
        HistoricalData(dim=2, num_derivatives=2)
    jdata.append_historical_data(x, y)
    tdata.append_historical_data(x, y)
    jm = jmcmc.GaussianProcessLogLikelihoodMCMC(
        jdata, derivatives=DS, noisy=True, bucket=8,
        rng_key=jax.random.PRNGKey(0), standardize=True, **kw)
    tm = tmcmc.GaussianProcessLogLikelihoodMCMC(
        tdata, noisy=True, bucket=8, standardize=True, device="cpu",
        dtype=F64, generator=torch.Generator().manual_seed(0),
        derivatives=DS, **kw)
    return jm, tm


def test_log_posterior_num_noise_matches_jax(rng):
    """num_noise = 3: the walker dimension, the prior and the per-channel
    noise slice, against JAX's vmapped log-posterior."""
    jm, tm = _models(rng)
    assert tm.num_noise == 3 and tm.prior.n_dims == 6 and tm.n_hypers == 16
    thetas = 0.5 * rng.standard_normal((8, 6)) - np.array(
        [0, 0, 0, 3, 3, 3])
    thetas[0, 0] = 25.0                     # out of bounds -> -inf
    xp, yp, pn = jm._padded_data()
    ref = np.asarray(jm._log_posterior_with_data()(jnp.asarray(thetas), xp,
                                                   yp, pn))
    got = tm.log_posterior(_t(thetas), *tm._padded_data()).numpy()
    assert np.isneginf(ref[0]) and np.isneginf(got[0])
    np.testing.assert_allclose(got[1:], ref[1:], rtol=1e-10)


def test_standardize_scales_derivative_channels(rng):
    """Port twin of tests/test_likelihood_mcmc.py:501: derivative channels
    scale by 1/std with no mean shift; the chain trains a 2-channel
    ensemble (and the walker picks carried from JAX give its ensemble)."""
    x = np.sort(rng.random(10))[:, None] * 2
    f = 50.0 + 20.0 * x[:, 0] ** 2
    g = 40.0 * x[:, 0]
    kw = dict(chain_length=40, burnin_steps=40, n_hypers=8, noisy=True,
              standardize=True)
    tdata = HistoricalData(dim=1, num_derivatives=1)
    tdata.append_historical_data(x, np.stack([f, g], axis=1),
                                 np.full(10, 1e-6))
    tm = tmcmc.GaussianProcessLogLikelihoodMCMC(
        tdata, derivatives=(0,), device="cpu", dtype=F64,
        generator=torch.Generator().manual_seed(5), **kw)
    scaled = tm._scaled_values()
    np.testing.assert_allclose(scaled[:, 0], (f - f.mean()) / f.std(),
                               rtol=1e-12)
    np.testing.assert_allclose(scaled[:, 1], g / f.std(), rtol=1e-12)
    jdata = JHist(dim=1, num_derivatives=1)
    jdata.append_historical_data(x, np.stack([f, g], axis=1),
                                 np.full(10, 1e-6))
    jm = jmcmc.GaussianProcessLogLikelihoodMCMC(
        jdata, derivatives=(0,), rng_key=jax.random.PRNGKey(5), **kw)
    np.testing.assert_allclose(scaled, jm._scaled_values(), rtol=1e-15)
    tm.train()
    assert tm.models.noise_variance.shape == (8, 2)
    assert tm.models.points_sampled_value.shape == (8, 10, 2)
    assert torch.isfinite(tm.models.chol_K).all()
    jm.train()
    convert.set_mcmc_walkers(tm, np.asarray(jm.p0), jm.hypers)
    tm._finalize_models()
    # the picked walkers' (S, 2) channel noises and hyperparameters, as the
    # JAX model's ensemble holds them (its near-noiseless walkers leave K
    # too ill-conditioned to compare the factors entry by entry)
    np.testing.assert_array_equal(tm.models.noise_variance.numpy(),
                                  np.asarray(jm.models.noise_variance))
    np.testing.assert_array_equal(
        tm.models.covariance.hyperparameters.numpy(),
        np.asarray(jm.models.covariance.hyperparameters))


# ---------------------------------------------------------------------------
# d-KG
# ---------------------------------------------------------------------------

@pytest.fixture
def problem(rng):
    x, y = _branin_data(rng, N)
    hypers = _hypers(rng, S)
    noises = np.full((S, 3), 1e-2)
    j = jmcmc.fit_gp_ensemble("matern_2.5", jnp.asarray(hypers),
                              jnp.asarray(noises), x, y, derivatives=DS)
    t = tmcmc.fit_gp_ensemble("matern_2.5", _t(hypers), _t(noises), x, y,
                              DS)
    return dict(j=j, t=t, unions=rng.random((B, Q, 2)),
                normals=rng.standard_normal((M, Q * 3)),
                normals_v=rng.standard_normal((M, Q)),
                discrete=rng.random((S, 5, 2)),
                best=np.array([-0.1, 0.0, 0.2]))


def _doms():
    return JDom.from_bounds([[0.0, 1.0]] * 2), \
        TDom.from_bounds([[0.0, 1.0]] * 2)


@pytest.mark.parametrize("ds", [(), (0,), DS])
def test_fantasy_model_batch_with_derivatives_matches_jax(problem, ds):
    ref = jax.vmap(lambda s: jkg._build_fantasy_model_batch(
        s, jnp.asarray(problem["unions"]), ds))(problem["j"])
    got = tkg._build_fantasy_model_batch(problem["t"],
                                         _t(problem["unions"]), ds)
    assert got[1].shape == (S, B, Q * (1 + len(ds)), Q * (1 + len(ds)))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL)


def test_fantasy_mean_and_descent_direction_match_jax(problem, rng):
    """The frozen fantasy mean over derivative channels and the autograd
    direction that drives the inner descent, against JAX's jax.grad of
    the summed mean."""
    qc = Q * 3
    v = 0.1 * rng.standard_normal((S, B, N * 3, qc))
    betas = rng.standard_normal((S, B, M, qc))
    x = rng.random((S, B, M, 2))
    unions, normals = problem["unions"], problem["normals"]
    mu_t = tkg._fantasy_mean_batch(problem["t"], _t(x), _t(unions), _t(v),
                                   _t(betas), _t(normals), DS)
    _, g_t = tkg._make_fantasy_mean_grad_fn(problem["t"], _t(unions), _t(v),
                                            _t(betas), _t(normals), DS)(_t(x))
    for i in range(S):
        member = jmcmc.ensemble_member(problem["j"], i)

        def neg_sum(xx):
            return -jnp.sum(jkg._fantasy_mean_batch(
                member, xx, jnp.asarray(unions), jnp.asarray(v[i]),
                jnp.asarray(betas[i]), jnp.asarray(normals), DS, 0))

        mu_j = -neg_sum(jnp.asarray(x[i]))
        np.testing.assert_allclose(float(mu_t[i].sum()), float(mu_j), **TOL)
        np.testing.assert_allclose(g_t[i].numpy(),
                                   np.asarray(jax.grad(neg_sum)(
                                       jnp.asarray(x[i]))), **TOL)


def _jax_batch(problem, params, ds, normals, inner_x0=None):
    jdom, _ = _doms()

    def f(u):
        return jkg.knowledge_gradient_mcmc_batch(
            problem["j"], u, jnp.asarray(problem["discrete"]),
            jnp.asarray(normals), jdom, params, jnp.asarray(problem["best"]),
            Q, derivatives_to_sample=ds, inner_x0=inner_x0,
            return_x_star=True)

    (vals, xs), vjp = jax.vjp(jax.jit(f), jnp.asarray(problem["unions"]))
    (grads,) = vjp((jnp.ones_like(vals), jnp.zeros_like(xs)))
    return vals, grads, xs


@pytest.mark.parametrize("mode", ["cold", "warm"])
@pytest.mark.parametrize("ds", [(), DS])
def test_dkg_batch_matches_jax(problem, mode, ds):
    """Values, union gradients and carried endpoints of the ensemble KG
    batch on a derivative-observed ensemble, value-only fantasies and d-KG,
    cold and in "reseed" warm mode (the same carry given to both)."""
    _, tdom = _doms()
    normals = problem["normals"] if ds else problem["normals_v"]
    params = topt.GradientDescentParameters(**INNER)
    args = (problem["t"], _t(problem["unions"]), _t(problem["discrete"]),
            _t(normals), tdom)
    carry = None
    if mode == "warm":
        _, _, carry = tkg.knowledge_gradient_mcmc_batch_vg_carry(
            *args, params, _t(problem["best"]), derivatives_to_sample=ds)
        params = dataclasses.replace(params, max_num_steps=1,
                                     num_steps_averaged=0)
    v_j, g_j, x_j = _jax_batch(
        problem, jopt.GradientDescentParameters(**dataclasses.asdict(params)),
        ds, normals,
        inner_x0=None if carry is None else jnp.asarray(carry.numpy()))
    v_t, g_t, x_t = tkg.knowledge_gradient_mcmc_batch_vg_carry(
        *args, params, _t(problem["best"]), inner_x0=carry,
        derivatives_to_sample=ds)
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j), **TOL)
    np.testing.assert_allclose(x_t.numpy(), np.asarray(x_j), **TOL)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), **GRAD)


def test_per_union_dkg_matches_jax(problem):
    jdom, tdom = _doms()
    ref = jax.jit(lambda u: jkg.knowledge_gradient_mcmc(
        problem["j"], u, jnp.asarray(problem["discrete"]),
        jnp.asarray(problem["normals"]), jdom,
        jopt.GradientDescentParameters(**INNER),
        jnp.asarray(problem["best"]), Q, derivatives_to_sample=DS))(
            jnp.asarray(problem["unions"][0]))
    got = tkg.knowledge_gradient_mcmc(
        problem["t"], _t(problem["unions"][0]), _t(problem["discrete"]),
        _t(problem["normals"]), tdom,
        topt.GradientDescentParameters(**INNER), _t(problem["best"]), DS)
    np.testing.assert_allclose(float(got), float(ref), **TOL)


# ---------------------------------------------------------------------------
# d-EI
# ---------------------------------------------------------------------------

def _dei_states():
    """One GP over sin(2x) with its derivative observed, in both packages
    (tests/test_dkg_fidelity_e2e.py:82's problem)."""
    x = np.linspace(-1.8, 1.8, 7)[:, None]
    y = np.stack([np.sin(2 * x[:, 0]), 2 * np.cos(2 * x[:, 0])], axis=1)
    t_state = tgp.fit_gp(tcov.make_covariance("matern_2.5", _t([1.0, 0.6])),
                         _t([1e-4, 1e-4]), _t(x), _t(y), derivatives=(0,))
    j_state = jgp.fit_gp(jcov.make_covariance("matern_2.5", [1.0, 0.6]),
                         jnp.asarray([1e-4, 1e-4]), jnp.asarray(x),
                         jnp.asarray(y), derivatives=(0,))
    return t_state, j_state, float(y[:, 0].min())


def test_dei_with_derivative_observations(rng):
    """Port twin of tests/test_dkg_fidelity_e2e.py:82 at its size: analytic
    and MC EI over a derivative-observed GP against the JAX package on the
    same normals."""
    t_state, j_state, best = _dei_states()
    a = float(tei.analytic_expected_improvement(t_state, _t([[0.9]]), best))
    assert a >= 0 and np.isfinite(a)
    np.testing.assert_allclose(a, float(jei.analytic_expected_improvement(
        j_state, jnp.asarray([[0.9]]), best)), rtol=1e-9, atol=1e-12)
    grid = rng.uniform(-2.0, 2.0, (6, 1, 1))
    np.testing.assert_allclose(
        tei.analytic_expected_improvement(t_state, _t(grid), best).numpy(),
        [float(jei.analytic_expected_improvement(j_state, jnp.asarray(p),
                                                 best)) for p in grid],
        rtol=1e-9, atol=1e-12)

    normals = rng.standard_normal((20000, 1))
    mc = float(tei.monte_carlo_expected_improvement(
        t_state, _t([[0.9]]), None, best, _t(normals)))
    np.testing.assert_allclose(mc, float(jei.monte_carlo_expected_improvement(
        j_state, jnp.asarray([[0.9]]), None, best, jnp.asarray(normals))),
        rtol=1e-9)
    np.testing.assert_allclose(mc, a, rtol=0.1, atol=2e-3)


@pytest.mark.parametrize("q, p", [(1, 0), (2, 1)])
def test_dei_multistart_matches_jax(monkeypatch, rng, q, p):
    """The per-start d-EI multistart against the JAX package's, both given
    the same Latin-hypercube starts and MC normals: the closed form at
    q = 1, p = 0, the MC estimator over the union with the points being
    sampled otherwise."""
    t_state, j_state, best = _dei_states()
    starts = rng.uniform(-2.0, 2.0, (5, q, 1))
    normals = rng.standard_normal((64, q + p))
    being = rng.uniform(-2.0, 2.0, (p, 1)) if p else None

    def lhc(wrap):
        def draw(domain, key, n):
            assert n == len(starts)
            return wrap(starts)
        return draw

    def mc(wrap):
        def draw(key, num, n, device=None, dtype=None):
            assert (num, n) == normals.shape
            return wrap(normals, dtype)
        return draw

    monkeypatch.setattr(JRep, "generate_latin_hypercube_points",
                        lhc(jnp.asarray))
    monkeypatch.setattr(TRep, "generate_latin_hypercube_points", lhc(_t))
    monkeypatch.setattr(jei, "draw_normals", mc(jnp.asarray))
    monkeypatch.setattr(tei, "draw_normals", mc(_t))
    params = dict(num_multistarts=5, max_num_steps=10, max_num_restarts=1,
                  num_steps_averaged=3, gamma=0.7, pre_mult=0.4,
                  max_relative_change=0.5)
    ref = jei.multistart_expected_improvement_optimization(
        jax.random.PRNGKey(0), j_state, JDom.from_bounds([[-2.0, 2.0]]), q,
        jopt.GradientDescentParameters(**params),
        points_being_sampled=None if p == 0 else jnp.asarray(being),
        best_so_far=best, num_mc_iterations=64)
    got = tei.multistart_expected_improvement_optimization(
        torch.Generator().manual_seed(0), t_state,
        TDom.from_bounds([[-2.0, 2.0]]), q,
        topt.GradientDescentParameters(**params),
        points_being_sampled=None if p == 0 else _t(being),
        best_so_far=best, num_mc_iterations=64)
    assert got.shape == (q, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **SLICE)


# ---------------------------------------------------------------------------
# objectives
# ---------------------------------------------------------------------------

def test_objectives_with_derivatives_match_jax(rng):
    """Hartmann6's hand-written gradient against JAX's value_and_grad, and
    the derivative objectives' observation settings."""
    tf, jf = tsf.Hartmann6(), jsf.Hartmann6()
    for p in rng.random((5, 6)):
        np.testing.assert_allclose(tf.evaluate_true(p), jf.evaluate_true(p),
                                   rtol=1e-12, atol=1e-14)
    for p in rng.random((3, 2)) * [15.0, 20.0] - [0.0, 5.0]:
        np.testing.assert_allclose(tsf.BraninWithDerivatives().evaluate_true(
            p), jsf.BraninWithDerivatives().evaluate_true(p), rtol=1e-12)
    for cls in ("BraninWithDerivatives", "Hartmann6WithDerivatives"):
        t, j = getattr(tsf, cls)(), getattr(jsf, cls)()
        assert t._observations == j._observations
        assert t._sample_var == j._sample_var and t._dim == j._dim
        p = rng.random(t._dim)
        np.testing.assert_allclose(t.evaluate(p), j.evaluate(p), rtol=1e-12,
                                   atol=1e-14)


# ---------------------------------------------------------------------------
# the d-KG slice and the driver
# ---------------------------------------------------------------------------

SQ, SM, NSTART = 2, 8, 4
OUTER = dict(num_multistarts=NSTART, max_num_steps=6, max_num_restarts=1,
             num_steps_averaged=3, gamma=0.7, pre_mult=1.0,
             max_relative_change=0.5)
INNER_WARM = dict(INNER, max_num_steps=1, num_steps_averaged=0)
RECOMMEND = dict(num_multistarts=1, max_num_steps=60, max_num_restarts=1,
                 num_steps_averaged=15, gamma=0.7, pre_mult=1.0,
                 max_relative_change=0.02)


@pytest.fixture
def slice_problem(rng):
    x, y = _branin_data(rng, 12)
    hypers = _hypers(rng, 4)
    noises = np.full((4, 3), 1e-2)
    return dict(
        j=jmcmc.fit_gp_ensemble("matern_2.5", jnp.asarray(hypers),
                                jnp.asarray(noises), x, y, derivatives=DS,
                                bucket=16),
        t=tmcmc.fit_gp_ensemble("matern_2.5", _t(hypers), _t(noises), x, y,
                                DS, bucket=16),
        starts=rng.random((NSTART, SQ, 2)),
        normals=rng.standard_normal((SM, SQ * 3)),
        normals_voi=rng.standard_normal((SM, SQ * 3)),
        discrete=rng.random((4, 6, 2)),
        grid=rng.random((100, 2)))


def _jax_slice(p):
    j, dom = p["j"], JDom.from_bounds([[0.0, 1.0]] * 2)
    rep = JRep(domain=dom, num_repeats=SQ)
    disc, normals = jnp.asarray(p["discrete"]), jnp.asarray(p["normals"])
    best = jbo.best_so_far_from_discretization(j, disc)
    cold = jopt.GradientDescentParameters(**INNER)
    warm = jopt.GradientDescentParameters(**INNER_WARM)

    def suggest(starts):
        def bvg_cold(u):
            return jkg.knowledge_gradient_mcmc_batch_vg_carry(
                j, u, disc, normals, dom, cold, best, SQ,
                derivatives_to_sample=DS)

        def bvg_warm(u, carry):
            return jkg.knowledge_gradient_mcmc_batch_vg_carry(
                j, u, disc, normals, dom, warm, best, SQ,
                derivatives_to_sample=DS, inner_x0=carry,
                warm_mode="reseed")

        res = jopt.multistart_optimize_batched_warm(
            bvg_cold, bvg_warm, rep, starts,
            jopt.GradientDescentParameters(**OUTER), chunk_size=2,
            conv_tol=3e-3)
        return res.best_point, res.best_value, res.all_points

    point, value, allp = jax.jit(suggest)(jnp.asarray(p["starts"]))
    voi = jax.jit(lambda u: jkg.knowledge_gradient_mcmc(
        j, u, disc, jnp.asarray(p["normals_voi"]), dom, cold, best, SQ,
        derivatives_to_sample=DS))(point)

    def neg_mean(x):
        return jnp.mean(jax.vmap(
            lambda s: jkg.posterior_mean_objective(s, x))(j))

    def recommend(guesses):
        vals = jax.vmap(neg_mean)(guesses)
        vals = jnp.where(jnp.isfinite(vals), vals, -jnp.inf)
        x0 = guesses[jnp.argmax(vals)]
        x = jopt.gradient_ascent(jax.value_and_grad(neg_mean), dom, x0,
                                 jopt.GradientDescentParameters(**RECOMMEND))
        return jnp.where(neg_mean(x) > vals.max(), x, x0)

    rec = jax.jit(recommend)(jnp.asarray(p["grid"]))
    return best, point, value, allp, voi, rec


def _torch_slice(p):
    t, dom = p["t"], TDom.from_bounds([[0.0, 1.0]] * 2)
    rep = TRep(domain=dom, num_repeats=SQ)
    disc, normals = _t(p["discrete"]), _t(p["normals"])
    best = tbo.best_so_far_from_discretization(t, disc)
    cold = topt.GradientDescentParameters(**INNER)
    warm = topt.GradientDescentParameters(**INNER_WARM)

    def bvg_cold(u):
        return tkg.knowledge_gradient_mcmc_batch_vg_carry(
            t, u, disc, normals, dom, cold, best, derivatives_to_sample=DS)

    def bvg_warm(u, carry):
        return tkg.knowledge_gradient_mcmc_batch_vg_carry(
            t, u, disc, normals, dom, warm, best, inner_x0=carry,
            derivatives_to_sample=DS)

    res = topt.multistart_optimize_batched_warm(
        bvg_cold, bvg_warm, rep, _t(p["starts"]),
        topt.GradientDescentParameters(**OUTER), chunk_size=2,
        conv_tol=3e-3)
    voi = tkg.knowledge_gradient_mcmc(t, res.best_point, disc,
                                      _t(p["normals_voi"]), dom, cold, best,
                                      DS)
    rec = tbo.recommend_from_guesses(
        t, dom, _t(p["grid"]), topt.GradientDescentParameters(**RECOMMEND))
    return best, res.best_point, res.best_value, res.all_points, voi, rec


def test_dkg_slice_matches_jax(slice_problem):
    """The d-KG slice as a whole: S = 4, 12 points x 3 channels (bucketed
    to 16), ds (0, 1), the same starts, normals and discretization; the
    warm gated multistart, the VOI and the recommendation."""
    names = ("best_so_far", "suggested", "kg_at_suggested", "all_endpoints",
             "voi", "recommended")
    for name, ref, got in zip(names, _jax_slice(slice_problem),
                              _torch_slice(slice_problem)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   err_msg=name, **SLICE)


def test_dkg_optimizer_run_on_cpu_is_finite():
    """Port twin of tests/test_dkg_fidelity_e2e.py:17: one d-KG iteration of
    the driver on Branin with both partials observed."""
    fast = topt.GradientDescentParameters(
        num_multistarts=4, max_num_steps=8, max_num_restarts=1,
        num_steps_averaged=2, gamma=0.7, pre_mult=1.0,
        max_relative_change=0.5)
    bo = tbo.BayesianOptimizer(
        objective_func=tsf.BraninWithDerivatives(), method="KG",
        num_to_sample=2, num_mc=8, n_hypers=8, chain_length=25,
        burnin_steps=25, noisy=False, chain_gate_tol=None, sgd_params=fast,
        device="cpu", verbose=False)
    h = bo.run(num_iterations=1)[0]
    assert h["suggested"].shape == (2, 2)
    assert np.isfinite(h["voi"]) and np.isfinite(h["true_value"])
    assert bo.model.models.points_sampled_value.shape[-1] == 3
    assert bo.model.models.noise_variance.shape[-1] == 3
    assert bo.model._data.num_sampled == 5
    # method "EI" is driven too (tests/test_torch_ei_driver.py); a method
    # the driver does not know is refused
    assert tbo.BayesianOptimizer(objective_func=tsf.Branin(), method="EI",
                                 device="cpu").num_mc == 2**10
    with pytest.raises(ValueError):
        tbo.BayesianOptimizer(objective_func=tsf.Branin(), method="UCB",
                              device="cpu")


# ---------------------------------------------------------------------------
# the kernel gates
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case, expected", [
    (dict(), "matern_2.5"),                              # the main path
    (dict(d=8, q=6), "matern_2.5"),                      # Wr = 63
    (dict(d=9), None),
    (dict(q=17), None),
    (dict(d=4, q=12), None),                             # Wr = 65
    (dict(derivatives=(0,)), None),
    (dict(derivatives_to_sample=(1,)), None),
    (dict(derivatives=DS, derivatives_to_sample=DS), None),
    (dict(device_type="cpu"), None),
    (dict(dtype=F64), None),
])
def test_descent_gate(case, expected):
    """Kernel A's gate sends shapes outside the descent kernels' limits and
    every derivative state to the plain route, as the JAX package's gate
    does (knowledge_gradient.py:771)."""
    args = dict(device_type="cuda", dtype=F32, kernel_name="matern_2.5",
                derivatives=(), derivatives_to_sample=(), d=2, q=4)
    args.update(case)
    assert tkg.descent_kernel_for(**args) == expected
    assert kernels.descent_shapes_supported(args["d"], args["q"]) == \
        ((1 + args["q"]) * (1 + args["d"]) <= 64 and args["d"] <= 8 and
         args["q"] <= 16)


@pytest.mark.parametrize("device_type, dtype, ds, expected_c, expected_b", [
    ("cuda", F32, (), True, True), ("cuda", F32, (0,), False, False),
    ("cuda", F32, DS, False, False), ("cpu", F32, (), False, False),
    ("cuda", F64, (), False, True), ("cuda", F64, (0,), False, False),
    ("cpu", F64, (), False, False)])
def test_covariance_and_lml_gates(device_type, dtype, ds, expected_c,
                                  expected_b):
    """Kernels C and B take value channels only, as the JAX package's
    pallas_available_for and LML gate do; C takes float32 alone, B float32
    and float64 (its float64 instance)."""
    assert tcov.uses_covariance_kernel(device_type, dtype, ds,
                                       "matern_2.5") == expected_c
    assert tmcmc.uses_lml_kernel(device_type, dtype, ds, 512) == expected_b
