"""Parity of the port's random features, Predictive Entropy Search and PES
driver with the JAX package, in float64.

Tolerances: a random-feature sample drawn from the JAX package's random
numbers (frequencies, phases and weights, passed in) at rtol 1e-9 / atol
1e-11 (the Woodbury branch's eigendecomposition at rtol 1e-8 / atol 1e-10),
and its polished minimum at rtol 1e-9 / atol 1e-11; the sampled functions'
statistics at tests/test_driver_extras.py:81-120's tolerances (mean atol
0.15, variance atol 0.1, values at the data atol 0.35, more than half of 12
Thompson draws near the minimum); the closed-form PES blocks against the
autodiff oracle at rtol 1e-10 / atol 1e-12 (tests/test_pes.py:164) and
against the JAX package at rtol 1e-12 / atol 1e-13; EP's sites and
conditioned operator and the PES state at rtol 1e-8 / atol 1e-10 (as
tests/test_pes.py:220 holds two EP runs; a site precision near 5e4
carries 60 damped iterations' rounding), the acquisition at rtol 1e-9 /
atol 1e-11; the closed-form Hessian and gradient of a sample against
``torch.func`` at rtol 1e-10 / atol 1e-10; the hyperparameter
log-posterior at rtol 1e-10 (tests/test_likelihood_mcmc.py:32) and its -inf
start walker for walker; the NaN-robust multi-set mean at rtol 1e-10
(tests/test_pes.py:116).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cornell_moe_tpu.acquisition import pes as jpes
from cornell_moe_tpu.acquisition import pes_driver as jdriver
from cornell_moe_tpu.models import covariance as jcov
from cornell_moe_tpu.models import gp as jgp
from cornell_moe_tpu.models import mcmc as jmcmc
from cornell_moe_tpu.models import priors as jpriors
from cornell_moe_tpu.ops import random_features as jrf
from cornell_moe_tpu.ops.domains import TensorProductDomain as JDom
from cornell_moe_tpu_torch.acquisition import pes as tpes
from cornell_moe_tpu_torch.acquisition import pes_driver as tdriver
from cornell_moe_tpu_torch.models import covariance as tcov
from cornell_moe_tpu_torch.models import gp as tgp
from cornell_moe_tpu_torch.models import mcmc as tmcmc
from cornell_moe_tpu_torch.models import priors as tpriors
from cornell_moe_tpu_torch.ops import linalg, programs
from cornell_moe_tpu_torch.ops import random_features as trf
from cornell_moe_tpu_torch.ops.domains import TensorProductDomain as TDom
from cornell_moe_tpu_torch.utils.logging_utils import PhaseTimer

torch.set_num_threads(1)
F64 = torch.float64
TOL = dict(rtol=1e-9, atol=1e-11)
EP_TOL = dict(rtol=1e-8, atol=1e-10)
BLOCK_TOL = dict(rtol=1e-12, atol=1e-13)


def _t(a):
    return torch.as_tensor(np.array(a), dtype=F64)


def jax_draws(key, n_features, dim, matern):
    """The random numbers the JAX package's sample_gp_with_random_features
    draws from ``key`` (random_features.py:43-51, :78-84), as the port's
    FeatureDraws."""
    kw, kb, kr = jax.random.split(key, 3)
    kz, kc = jax.random.split(kw)
    z = jax.random.normal(kz, (n_features, dim), dtype=jnp.float64)
    u = 2.0 * jax.random.gamma(kc, 2.5, (n_features, 1),
                               dtype=jnp.float64) if matern else None
    b = jax.random.uniform(kb, (n_features,), dtype=jnp.float64,
                           maxval=2.0 * math.pi)
    r = jax.random.normal(kr, (n_features,), dtype=jnp.float64)
    return trf.FeatureDraws(z=_t(z), u=None if u is None else _t(u),
                            b=_t(b), r=_t(r))


def _stacked_draws(keys, n_features, dim, matern):
    draws = [jax_draws(k, n_features, dim, matern) for k in keys]
    return trf.FeatureDraws(*[None if f[0] is None else torch.stack(f)
                              for f in zip(*draws)])


def _states(kernel, hypers, noise, x, y, ds=()):
    j = jgp.fit_gp(jcov.make_covariance(kernel, hypers), jnp.asarray(noise),
                   jnp.asarray(x), jnp.asarray(y), derivatives=ds)
    t = tgp.fit_gp(tcov.make_covariance(kernel, _t(hypers)), _t(noise),
                   _t(x), _t(y), derivatives=ds)
    return j, t


def _gp_1d(rng, n=10, noise=1e-3, kernel="square_exponential"):
    """tests/test_driver_extras.py:72's GP in both packages."""
    x = np.sort(rng.random(n) * 4 - 2)[:, None]
    y = np.sin(2 * x[:, 0])[:, None]
    return _states(kernel, [1.0, 0.6], [noise], x, y)


# ---------------------------------------------------------------------------
# random features
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kernel, branch, n_features, ds", [
    ("square_exponential", "woodbury", 64, ()),
    ("matern_2.5", "woodbury", 64, (0, 1)),
    ("square_exponential", "direct", 8, (0, 1)),
    ("matern_2.5", "direct", 8, ())])
def test_random_feature_sample_matches_jax(rng, kernel, branch, n_features,
                                           ds):
    """The same sample from the same draws: the Woodbury branch (fewer
    observation channels than features) and the direct one, value and
    derivative observations, both spectral measures."""
    x = rng.random((6, 2))
    y = np.stack([np.sin(3 * x[:, 0]) + x[:, 1], 3 * np.cos(3 * x[:, 0]),
                  np.ones(6)], axis=1)[:, :1 + len(ds)]
    j, t = _states(kernel, [1.2, 0.5, 0.7], [1e-3] * (1 + len(ds)), x, y, ds)
    key = jax.random.PRNGKey(3)
    ref = jax.jit(lambda k, st: jrf.sample_gp_with_random_features(
        k, st, n_features))(key, j)
    got = trf.sample_gp_with_random_features(
        None, t, n_features, draws=jax_draws(key, n_features, 2,
                                             kernel == "matern_2.5"))
    tol = dict(rtol=1e-8, atol=1e-10) if branch == "woodbury" else TOL
    for name in ("w", "b", "scale"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)), **TOL)
    np.testing.assert_allclose(got.theta.numpy(), np.asarray(ref.theta), **tol)
    pts = rng.random((5, 2))
    np.testing.assert_allclose(
        trf.evaluate_random_feature_sample(got, _t(pts)).numpy(),
        np.asarray(jrf.evaluate_random_feature_sample(ref, jnp.asarray(pts))),
        **tol)


def test_sample_minimum_and_hessian_match_jax(rng):
    """Per set, the JAX package's x* draw and autodiff Hessian, against the
    port's batch over 3 sets (SE fit per set, the sample from the JAX
    draws of the set's key, the polished minimum, the closed-form
    Hessian), at d = 2 on a 30-point grid."""
    x = rng.random((8, 2))
    y = np.sin(3 * x[:, 0]) + x[:, 1] ** 2
    sigma = np.array([1.1, 0.8, 1.5])
    lengths = 0.3 + 0.4 * rng.random((3, 2))
    noise = np.array([1e-3, 2e-3, 1e-3])
    grid = rng.random((30, 2))
    keys = jax.random.split(jax.random.PRNGKey(5), 3)
    jdom = JDom.from_bounds([[0.0, 1.0]] * 2)
    x_min, hess = tdriver.sample_minimum_with_hessian(
        None, _t(x), _t(y), _t(sigma), _t(lengths), _t(noise),
        TDom.from_bounds([[0.0, 1.0]] * 2), _t(grid),
        draws=_stacked_draws(keys, tdriver.NUM_FEATURES, 2, False))
    ref_fn = jax.jit(lambda k, s, ls, nz: jdriver.sample_minimum_with_hessian(
        k, jnp.asarray(x), jnp.asarray(y), s, ls, nz, jdom, jnp.asarray(grid)))
    for i in range(3):
        ref_x, ref_h = ref_fn(keys[i], sigma[i], jnp.asarray(lengths[i]),
                              noise[i])
        np.testing.assert_allclose(x_min[i].numpy(), np.asarray(ref_x), **TOL)
        np.testing.assert_allclose(hess[i].numpy(), np.asarray(ref_h),
                                   rtol=1e-8, atol=1e-8)


def test_closed_form_gradient_and_hessian_match_autograd(rng):
    """The sample's closed-form gradient and Hessian, batched over 3
    samples, against torch.func.grad / hessian of its value."""
    x = rng.random((8, 3))
    t = tmcmc.fit_gp_ensemble(
        "square_exponential", _t([[1.0, 0.4, 0.6, 0.5], [1.3, 0.7, 0.3, 0.9],
                                  [0.9, 0.5, 0.5, 0.5]]),
        _t(np.full((3, 1), 1e-3)), x, np.sin(x.sum(1))[:, None])
    sample = trf.sample_gp_with_random_features(
        torch.Generator().manual_seed(0), t, 200)
    at = _t(rng.random((3, 3)))
    hess = trf.random_feature_hessian(sample, at)
    grad = trf.random_feature_gradient(sample, at)
    for i in range(3):
        one = trf.RandomFeatureSample(*[f[i] for f in sample])

        def f(p):
            return trf.evaluate_random_feature_sample(one, p[None])[0]

        np.testing.assert_allclose(hess[i].numpy(),
                                   torch.func.hessian(f)(at[i]).numpy(),
                                   rtol=1e-10, atol=1e-10)
        np.testing.assert_allclose(grad[i].numpy(),
                                   torch.func.grad(f)(at[i]).numpy(),
                                   rtol=1e-10, atol=1e-10)


def test_random_feature_sample_approximates_posterior(rng):
    """Port twin of tests/test_driver_extras.py:81: 300 samples' mean and
    variance at 7 points against the posterior."""
    _, state = _gp_1d(rng)
    xt = _t(np.linspace(-2, 2, 7)[:, None])
    draws = trf.draw_features(torch.Generator().manual_seed(0), (300,), 600,
                              1, False, dtype=F64)
    vals = trf.evaluate_random_feature_sample(
        trf.sample_gp_with_random_features(None, state, 600, draws=draws), xt)
    assert vals.shape == (300, 7)
    mu = tgp.posterior_mean(state, xt)[:, 0].numpy()
    np.testing.assert_allclose(vals.mean(0).numpy(), mu, atol=0.15)
    var = torch.diagonal(tgp.posterior_variance(state, xt)).numpy()
    np.testing.assert_allclose(vals.var(0, correction=0).numpy(), var,
                               atol=0.1)


def test_sample_from_global_optima(rng):
    """Port twin of tests/test_driver_extras.py:96."""
    _, state = _gp_1d(rng, n=14, noise=1e-6)
    pts = trf.sample_from_global_optima(
        torch.Generator().manual_seed(1), state,
        TDom.from_bounds([[-2.0, 2.0]]), _t(np.linspace(-2, 2, 60)[:, None]),
        12, n_features=400)
    assert pts.shape == (12, 1)
    assert np.mean(np.abs(pts[:, 0].numpy() + np.pi / 4) < 0.4) > 0.5


@pytest.mark.parametrize("kernel", ["square_exponential", "matern_2.5"])
def test_rff_with_derivative_observations(kernel):
    """Port twin of tests/test_driver_extras.py:108, both spectral
    measures."""
    x = np.linspace(-1.5, 1.5, 6)[:, None]
    y = np.stack([np.sin(2 * x[:, 0]), 2 * np.cos(2 * x[:, 0])], axis=1)
    _, state = _states(kernel, [1.0, 0.7], [1e-4, 1e-4], x, y, (0,))
    s = trf.sample_gp_with_random_features(torch.Generator().manual_seed(2),
                                           state, 500)
    np.testing.assert_allclose(
        trf.evaluate_random_feature_sample(s, _t(x)).numpy(), y[:, 0],
        atol=0.35)


# ---------------------------------------------------------------------------
# PES
# ---------------------------------------------------------------------------

def test_closed_form_blocks_match_oracle_and_jax(rng):
    """tests/test_pes.py:149's problem (n 7, d 3): the closed-form joint
    covariance against the port's torch.func oracle and against the JAX
    package; a stack of two sets equals each set alone; the cross matrix
    against the JAX package."""
    n, d = 7, 3
    x = rng.random((n, d))
    x_min = rng.random((2, d))
    sigma, noise = np.array([1.7, 0.9]), np.array([1e-3, 2e-3])
    lengths = 0.4 + rng.random((2, d))
    got = tpes.build_pes_covariance(_t(x), _t(x_min), _t(sigma), _t(lengths),
                                    _t(noise))
    assert got.K.shape == (2, n + 2 * d + 3 + 1, n + 2 * d + 3 + 1)
    assert (got.n, got.d, got.n_off) == (n, d, 3)
    xs = rng.random((4, d))
    cross = tpes.pes_cross_matrix(_t(xs), _t(x), _t(x_min), _t(sigma),
                                  _t(lengths))
    oracle = tpes._build_pes_covariance_autodiff(
        _t(x), _t(x_min[0]), _t(sigma[0]), _t(lengths[0]), _t(noise[0]))
    np.testing.assert_allclose(got.K[0].numpy(), oracle.K.numpy(),
                               rtol=1e-10, atol=1e-12)
    for i in range(2):
        one = tpes.build_pes_covariance(_t(x), _t(x_min[i]), _t(sigma[i]),
                                        _t(lengths[i]), _t(noise[i]))
        np.testing.assert_allclose(one.K.numpy(), got.K[i].numpy(),
                                   rtol=1e-15, atol=0.0)
        ref = jax.jit(jpes.build_pes_covariance)(
            jnp.asarray(x), jnp.asarray(x_min[i]), sigma[i],
            jnp.asarray(lengths[i]), noise[i])
        np.testing.assert_allclose(got.K[i].numpy(), np.asarray(ref.K),
                                   **BLOCK_TOL)
        np.testing.assert_allclose(
            cross[i].numpy(), np.asarray(jax.jit(jpes.pes_cross_matrix)(
                jnp.asarray(xs), jnp.asarray(x), jnp.asarray(x_min[i]),
                sigma[i], jnp.asarray(lengths[i]))), **BLOCK_TOL)


def _pes_problem(rng, m=3, n=8, d=2):
    x = rng.random((n, d))
    y = np.sin(4 * x[:, 0]) + x[:, 1] - 0.5
    x_min = rng.random((m, d))
    a = rng.standard_normal((m, d, d))
    hess = a @ a.transpose(0, 2, 1) + d * np.eye(d)
    return dict(x=x, y=y, x_min=x_min, hess=hess,
                sigma=1.0 + 0.5 * rng.random(m),
                lengths=0.4 + 0.4 * rng.random((m, d)),
                noise=1e-3 * (1.0 + rng.random(m)))


_jax_make_pes_state = jax.jit(jpes.make_pes_state)


def _jax_state(p, i):
    return _jax_make_pes_state(
        jnp.asarray(p["x"]), jnp.asarray(p["y"]), jnp.asarray(p["x_min"][i]),
        jnp.asarray(p["hess"][i]), p["sigma"][i], jnp.asarray(p["lengths"][i]),
        p["noise"][i])


def _torch_state(p):
    return tpes.make_pes_state(_t(p["x"]), _t(p["y"]), _t(p["x_min"]),
                               _t(p["hess"]), _t(p["sigma"]),
                               _t(p["lengths"]), _t(p["noise"]))


def test_ep_and_pes_state_match_jax(rng):
    """EP's sites and conditioned operator, and every field of the PES
    state, for 3 sets at once against the JAX package set by set, through
    both routes of the sweeps: called directly and as one program of a
    ``ProgramCache`` (one build, 60 replays with the damping an input),
    equal bit for bit.  The sweep's inverse is ``torch.linalg.inv_ex``
    (no host read); it equals ``torch.linalg.inv`` bit for bit here."""
    p = _pes_problem(rng)
    ch = tpes.build_pes_covariance(_t(p["x"]), _t(p["x_min"]),
                                   _t(p["sigma"]), _t(p["lengths"]),
                                   _t(p["noise"]))
    hess_off = _t(p["hess"][:, 0, 1:2])
    kw, cm, (mt, vti) = tpes.expectation_propagation(ch, _t(p["y"]),
                                                     hess_off, _t(p["noise"]))
    cache = programs.ProgramCache()
    routes = tpes.expectation_propagation(ch, _t(p["y"]), hess_off,
                                          _t(p["noise"]),
                                          program_cache=cache)
    (key, prog), = cache.programs().items()
    assert key[0] == "ep_step" and prog.replays == 60
    for a, b in zip((kw, cm, mt, vti), (routes[0], routes[1], *routes[2])):
        assert torch.equal(a, b)
    site = linalg.symmetrize(torch.diag_embed(vti) + ch.K[..., -3:, -3:])
    assert torch.equal(torch.linalg.inv_ex(site)[0], torch.linalg.inv(site))
    assert torch.equal(torch.linalg.inv_ex(ch.K)[0], torch.linalg.inv(ch.K))
    state = _torch_state(p)
    stepped = tpes.make_pes_state(
        _t(p["x"]), _t(p["y"]), _t(p["x_min"]), _t(p["hess"]),
        _t(p["sigma"]), _t(p["lengths"]), _t(p["noise"]),
        program_cache=programs.ProgramCache())
    for name in tpes.PESState._fields:
        assert torch.equal(getattr(state, name), getattr(stepped, name))

    @jax.jit
    def jax_ep(x_min, sigma, lengths, noise, hess_off):
        jch = jpes.build_pes_covariance(jnp.asarray(p["x"]), x_min, sigma,
                                        lengths, noise)
        return jpes.expectation_propagation(jch, jnp.asarray(p["y"]),
                                            hess_off, noise)

    for i in range(3):
        rkw, rcm, (rmt, rvti) = jax_ep(
            jnp.asarray(p["x_min"][i]), p["sigma"][i],
            jnp.asarray(p["lengths"][i]), p["noise"][i],
            jnp.asarray(p["hess"][i, 0, 1:2]))
        for got, ref in ((kw, rkw), (cm, rcm), (mt, rmt), (vti, rvti)):
            np.testing.assert_allclose(got[i].numpy(), np.asarray(ref),
                                       **EP_TOL)
        ref_state = _jax_state(p, i)
        for name in tpes.PESState._fields:
            np.testing.assert_allclose(getattr(state, name)[i].numpy(),
                                       np.asarray(getattr(ref_state, name)),
                                       err_msg=name, **EP_TOL)
    assert torch.all(state.v_f_min > 0)


def test_pes_acquisition_matches_jax(rng):
    """The acquisition of 3 sets at 9 points against the JAX package point
    by point, and the multi-set NaN-mean with a failed set dropped
    (tests/test_pes.py:106)."""
    p = _pes_problem(rng)
    state = _torch_state(p)
    pts = rng.random((9, 2))
    got = tpes.pes_acquisition(_t(pts), state, _t(p["x"]))
    assert got.shape == (3, 9)
    acq = jax.jit(jax.vmap(jpes.pes_acquisition, in_axes=(0, None, None)))
    for i in range(3):
        ref = acq(jnp.asarray(pts), _jax_state(p, i), jnp.asarray(p["x"]))
        np.testing.assert_allclose(got[i].numpy(), np.asarray(ref), **TOL)
    bad = state._replace(m_f_min=torch.where(
        torch.arange(3) == 1, float("nan"), state.m_f_min))
    multi = tpes.pes_acquisition_multi(_t(pts), bad, _t(p["x"]))
    np.testing.assert_allclose(multi.numpy(),
                               got[[0, 2]].mean(0).numpy(), rtol=1e-10)
    jstates = jax.tree.map(lambda *a: jnp.stack(a),
                           *[_jax_state(p, i) for i in range(3)])
    jbad = jstates._replace(m_f_min=jstates.m_f_min.at[1].set(jnp.nan))
    ref = jax.jit(jax.vmap(lambda q: jpes.pes_acquisition_multi(
        q, jbad, jnp.asarray(p["x"]))))(jnp.asarray(pts))
    np.testing.assert_allclose(multi.numpy(), np.asarray(ref), **TOL)


def test_pes_acquisition_positive_and_informative(rng):
    """Port twin of tests/test_pes.py:89 on its 1-d problem."""
    x = np.sort(rng.random(8) * 4 - 2)[:, None]
    y = np.sin(2 * x[:, 0])
    state = tpes.make_pes_state(_t(x), _t(y), _t([-np.pi / 4]), _t([[4.0]]),
                                1.0, _t([0.7]), 1e-3)
    assert float(state.m_f_min) <= y.min() + 0.5
    vals = tpes.pes_acquisition(_t(np.linspace(-2, 2, 41)[:, None]), state,
                                _t(x))
    at_data = tpes.pes_acquisition(_t(x[3:4]), state, _t(x))
    assert torch.isfinite(vals).all()
    assert vals.max() > at_data[0] and vals.max() > 0


# ---------------------------------------------------------------------------
# the PES driver
# ---------------------------------------------------------------------------

def test_lognormal_prior_matches_jax(rng):
    theta = rng.standard_normal((20, 3))
    got = tpriors.LognormalPrior(sigma=1.0).lnprob(_t(theta))
    ref = [float(jpriors.LognormalPrior(sigma=1.0).lnprob(jnp.asarray(t)))
           for t in theta]
    assert np.array_equal(np.isneginf(got.numpy()), np.isneginf(ref))
    fin = np.isfinite(ref)
    np.testing.assert_allclose(got.numpy()[fin], np.asarray(ref)[fin],
                               rtol=1e-12)
    draws = tpriors.LognormalPrior(sigma=0.5, mean=1.0).sample_from_prior(
        torch.Generator().manual_seed(0), 400, 2)
    assert draws.shape == (400, 2) and bool((draws > 1.0).all())


def test_sample_hypers_start_is_mostly_minus_inf_in_both_packages(
        rng, monkeypatch):
    """The reference puts lognormal priors on the LOG amplitude and lengths
    (pes_driver.py:46-52), so every walker with one of those d + 1
    coordinates <= 0 starts at -inf.  At d = 6 and M = 100 walkers from
    0.3 N(0, 1), about 127 in 128 do.  Both packages' log-posteriors at the
    JAX package's start agree walker for walker: -inf at the same walkers,
    equal (rtol 1e-10) elsewhere."""
    x = rng.random((20, 6))
    y = np.sin(3 * x).sum(1)
    seen = {}

    def capture(key, log_prob, p0, num_steps):
        seen["p0"], seen["lp"] = np.asarray(p0), np.asarray(log_prob(p0))
        return p0, log_prob(p0)

    monkeypatch.setattr(jmcmc, "run_ensemble_mcmc", capture)
    jdriver.sample_hypers(jax.random.PRNGKey(0), jnp.asarray(x),
                          jnp.asarray(y), num_sets=100, burnin=50)
    got = tdriver.log_posterior_hypers(_t(seen["p0"]), _t(x), _t(y)).numpy()
    assert seen["p0"].shape == (100, 8)
    assert np.array_equal(np.isneginf(got), np.isneginf(seen["lp"]))
    fin = np.isfinite(seen["lp"])
    np.testing.assert_allclose(got[fin], seen["lp"][fin], rtol=1e-10)
    assert np.isneginf(got).sum() >= 95
    expected_inf = np.any(seen["p0"][:, :7] <= 0.0, axis=1)
    assert np.array_equal(np.isneginf(got), expected_inf)


def test_sample_hypers_shapes(rng):
    """Port twin of tests/test_pes.py:119."""
    noise, lengths, sigma = tdriver.sample_hypers(
        torch.Generator().manual_seed(0), _t(rng.random((8, 2))),
        _t(rng.standard_normal(8)), num_sets=6, burnin=20)
    assert noise.shape == (6,) and lengths.shape == (6, 2)
    assert sigma.shape == (6,)
    assert bool((noise > 0).all()) and bool((sigma > 0).all())


def test_run_pes_smoke(tmp_path):
    """Port twin of tests/test_pes.py:131 (there marked slow), on the CPU:
    two iterations on a 1-d quadratic with the artifacts, each iteration's
    four parts timed into the given PhaseTimer."""
    def quad(p):
        return float(np.sum((np.asarray(p) - 0.3) ** 2))

    timer = PhaseTimer()
    history = tdriver.run_PES(
        quad, [0.0], [1.0], 1, number_of_hyperparameter_sets=4,
        number_of_burnin=10, number_of_initial_points=3,
        number_of_iterations=2, gridsize=40, seed=0,
        output_dir=str(tmp_path), verbose=False, device="cpu", timer=timer)
    assert [r["phase"] for r in timer.records] == 2 * [
        "hyperparameters", "x_star_draws_and_ep", "acquisition", "recommend"]
    assert all(0 <= r["finite_sets"] <= 4 for r in timer.records
               if r["phase"] == "x_star_draws_and_ep")
    assert len(history) == 2
    assert history[-1]["best_so_far"] <= history[0]["best_so_far"] + 1e-12
    assert np.loadtxt(tmp_path / "Xsamples.txt").shape[0] == 5
    assert np.loadtxt(tmp_path / "Ysamples.txt").shape[0] == 5
    assert np.loadtxt(tmp_path / "guesses.txt").shape[0] == 5
    for h in history:
        assert 0.0 <= float(h["suggested"][0]) <= 1.0
        assert 0.0 <= float(h["recommended"][0]) <= 1.0


@pytest.mark.parametrize("du,dv", [((0,), ()), ((0,), (1,)),
                                   ((0, 1), (0, 1)), ((1, 0), (1, 0)),
                                   ((), (1, 1))])
def test_cov_deriv_matches_fd_and_jax(du, dv):
    """cov_deriv indexes the derivative tensor: equal to the JAX package's
    nested-jacfwd cov_deriv at rtol 1e-12, and held to central
    differences as in tests/test_pes.py:15 (first and mixed second
    derivatives at rtol 1e-6 and 1e-4); the fourth derivative is
    symmetric in the order of its indices."""
    from reference_impl import central_difference, se_kernel

    sigma, lengths = 1.3, np.array([0.8, 1.2])
    rng = np.random.default_rng(0)
    u, v = rng.standard_normal(2), rng.standard_normal(2)
    k_t = tpes._se_kernel(torch.tensor(sigma, dtype=torch.float64),
                          _t(lengths))
    k_j = jpes._se_kernel(jnp.asarray(sigma), jnp.asarray(lengths))
    got = float(tpes.cov_deriv(k_t, du, dv)(_t(u), _t(v)))
    ref = float(jpes.cov_deriv(k_j, du, dv)(jnp.asarray(u), jnp.asarray(v)))
    np.testing.assert_allclose(got, ref, rtol=1e-12)
    if (du, dv) == ((0,), ()):
        fd = central_difference(lambda a: se_kernel(sigma, lengths, a, v), u)
        np.testing.assert_allclose(got, fd[0], rtol=1e-6)
    elif (du, dv) == ((0,), (1,)):
        fd2 = central_difference(lambda vv: central_difference(
            lambda a: se_kernel(sigma, lengths, a, vv), u)[0], v, eps=1e-5)
        np.testing.assert_allclose(got, fd2[1], rtol=1e-4)
    elif len(du) == 2:
        swapped = tpes.cov_deriv(k_t, du[::-1], dv[::-1])(_t(u), _t(v))
        np.testing.assert_allclose(got, float(swapped), rtol=1e-10)
