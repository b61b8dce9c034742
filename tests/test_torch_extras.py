"""Parity of the port's model-layer extras with the JAX package, in float64
on the CPU: the posterior extras (fantasy update vector, posterior sampling
on given normals, the posterior Cholesky variance and the posterior
gradients), the hyperparameter gradients of the covariance, the likelihood
gradients, leave-one-out and hyperparameter-list evaluation, the
line-search ascent, damped Newton and the MAP fit, the simplex and dummy
domains, the MCMC model's small surface, checkpoints (the port's own and
one the JAX package wrote), the synthetic objectives, the logging helpers
and the HeSBO projection.  Each test feeds the same numpy inputs, made from
a seed, to both packages.

Tolerance: ``TOL`` (rtol 1e-7, atol 1e-9), the whole-slice tolerance of
tests/test_torch_driver.py; a looser one is stated beside its case.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cornell_moe_tpu.models import covariance as jcov
from cornell_moe_tpu.models import gp as jgp
from cornell_moe_tpu.models import likelihood as jlik
from cornell_moe_tpu.models import mcmc as jmcmc
from cornell_moe_tpu.ops import domains as jdom
from cornell_moe_tpu.ops import optimizers as jopt
from cornell_moe_tpu.utils import checkpoint as jck
from cornell_moe_tpu.utils import hesbo as jhesbo
from cornell_moe_tpu.utils import synthetic_functions as jsf
from cornell_moe_tpu.utils.data_containers import HistoricalData as JData
from cornell_moe_tpu_torch import convert
from cornell_moe_tpu_torch.models import covariance as tcov
from cornell_moe_tpu_torch.models import gp as tgp
from cornell_moe_tpu_torch.models import likelihood as tlik
from cornell_moe_tpu_torch.models import mcmc as tmcmc
from cornell_moe_tpu_torch.ops import domains as tdom
from cornell_moe_tpu_torch.ops import kernels
from cornell_moe_tpu_torch.ops import optimizers as topt
from cornell_moe_tpu_torch.utils import checkpoint as tck
from cornell_moe_tpu_torch.utils import hesbo as thesbo
from cornell_moe_tpu_torch.utils import logging_utils as tlog
from cornell_moe_tpu_torch.utils import synthetic_functions as tsf
from cornell_moe_tpu_torch.utils.data_containers import HistoricalData

torch.set_num_threads(1)
TOL = dict(rtol=1e-7, atol=1e-9)
COVARIANCES = ["matern_2.5", "square_exponential"]


def _t(a):
    return torch.as_tensor(np.array(a), dtype=torch.float64)


def _jx(fn):
    """A JAX reference computed as one jitted program: run eagerly, each of
    its operations would compile on its own."""
    return jax.jit(fn)()


def _close(got, ref, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               **(tol or TOL))


def _problem(seed, n=12, ds=()):
    """Points (n, 2), values over 1 + len(ds) channels, and one kernel's
    hyperparameters."""
    r = np.random.default_rng(seed)
    x = r.random((n, 2))
    y = np.stack([np.sin(3 * x[:, 0]) + x[:, 1], 3 * np.cos(3 * x[:, 0]),
                  np.ones(n)], axis=1)[:, :1 + len(ds)]
    return x, y, np.array([1.2, 0.4, 0.6])


def _gp_pair(kernel, ds=(), seed=0):
    x, y, h = _problem(seed, ds=ds)
    noise = np.full(1 + len(ds), 1e-2)
    j = jgp.fit_gp(jcov.COVARIANCE_TYPES[kernel](hyperparameters=
                                                 jnp.asarray(h)),
                   jnp.asarray(noise), x, y, ds)
    t = tgp.fit_gp(tcov.COVARIANCE_TYPES[kernel](hyperparameters=_t(h)),
                   _t(noise), _t(x), _t(y), ds)
    return j, t


# ---------------------------------------------------------------------------
# the posterior extras (models/gp.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ds,ds_sample", [((), ()), ((0, 1), (1,))],
                         ids=["values", "derivatives"])
def test_posterior_extras_match_jax(ds, ds_sample):
    j, t = _gp_pair("matern_2.5", ds)
    r = np.random.default_rng(1)
    pts, union = r.random((3, 2)), r.random((2, 2))
    a = r.standard_normal((2 * (1 + len(ds_sample)),) * 2)
    chol_u = np.linalg.cholesky(a @ a.T + np.eye(a.shape[0]))
    _close(tgp.posterior_cholesky_variance(t, _t(pts), ds_sample,
                                           jitter=1e-10),
           _jx(lambda: jgp.posterior_cholesky_variance(j, pts, ds_sample,
                                                       jitter=1e-10)))
    _close(tgp.grad_posterior_mean(t, _t(pts), ds_sample),
           _jx(lambda: jgp.grad_posterior_mean(j, pts, ds_sample)))
    _close(tgp.grad_posterior_variance(t, _t(pts), ds_sample),
           _jx(lambda: jgp.grad_posterior_variance(j, pts, ds_sample)))
    # the Cholesky factor's derivative amplifies the rounding of the
    # variance's (its pivots are ~1e-2): rtol 1e-6
    _close(tgp.grad_posterior_cholesky_variance(t, _t(pts), ds_sample,
                                                jitter=1e-10),
           _jx(lambda: jgp.grad_posterior_cholesky_variance(
               j, pts, ds_sample, jitter=1e-10)),
           rtol=1e-6, atol=1e-9)
    _close(tgp.fantasy_update_vector(t, _t(union), _t(pts), _t(chol_u),
                                     ds_sample),
           _jx(lambda: jgp.fantasy_update_vector(
               j, union, pts, jnp.asarray(chol_u), ds_sample)))
    assert t.num_derivatives == j.num_derivatives == len(ds)
    _close(t.best_observed_point, j.best_observed_point, rtol=0, atol=0)


def test_posterior_sampling_on_the_jax_normals():
    """The JAX package's draws for a key, passed in: same samples; drawn
    from a generator: finite, of the right shape."""
    j, t = _gp_pair("matern_2.5")
    key = jax.random.PRNGKey(11)
    pt, pts = np.array([0.3, 0.7]), np.random.default_rng(2).random((4, 2))
    z = jax.random.normal(key, dtype=jnp.float64)
    zs = jax.random.normal(key, (4,), dtype=jnp.float64)
    _close(tgp.sample_point_from_gp(None, t, _t(pt), normal=_t(z)),
           _jx(lambda: jgp.sample_point_from_gp(key, j, pt)))
    _close(tgp.sample_point_from_gp(None, t, _t(pt), noise_variance=0.5,
                                    normal=_t(z)),
           _jx(lambda: jgp.sample_point_from_gp(key, j, pt,
                                                noise_variance=0.5)))
    _close(tgp.sample_points_from_gp(None, t, _t(pts), normals=_t(zs)),
           _jx(lambda: jgp.sample_points_from_gp(key, j, pts)))
    g = torch.Generator().manual_seed(0)
    drawn = tgp.sample_points_from_gp(g, t, _t(pts))
    assert drawn.shape == (4,) and bool(torch.isfinite(drawn).all())
    assert tgp.sample_point_from_gp(g, t, _t(pt)).shape == ()


# ---------------------------------------------------------------------------
# hyperparameter gradients (models/covariance.py, models/likelihood.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kernel", COVARIANCES)
@pytest.mark.parametrize("ds", [(), (0, 1)], ids=["values", "derivatives"])
def test_hyperparameter_grad_covariance_matches_jax(kernel, ds):
    x, _, h = _problem(3, n=5)
    jc = jcov.COVARIANCE_TYPES[kernel](hyperparameters=jnp.asarray(h))
    tc = tcov.COVARIANCE_TYPES[kernel](hyperparameters=_t(h))
    _close(tc.hyperparameter_grad_covariance(_t(x[0]), _t(x[1])),
           _jx(lambda: jc.hyperparameter_grad_covariance(
               jnp.asarray(x[0]), jnp.asarray(x[1]))))
    _close(tcov.hyperparameter_grad_covariance_matrix(tc, _t(x), ds),
           _jx(lambda: jcov.hyperparameter_grad_covariance_matrix(
               jc, jnp.asarray(x), ds)))


@pytest.mark.parametrize("kernel,ds", [("matern_2.5", ()),
                                       ("square_exponential", (0, 1))],
                         ids=["values", "derivatives"])
def test_likelihood_gradients_loo_and_list_match_jax(kernel, ds):
    x, y, h = _problem(4, ds=ds)
    noise = np.full(1 + len(ds), 2e-2)
    jc = jcov.COVARIANCE_TYPES[kernel](hyperparameters=jnp.asarray(h))
    tc = tcov.COVARIANCE_TYPES[kernel](hyperparameters=_t(h))
    args_j = (jnp.asarray(noise), jnp.asarray(x), jnp.asarray(y), ds)
    args_t = (_t(noise), _t(x), _t(y), ds)
    _close(tlik.grad_log_marginal_likelihood(tc, *args_t),
           _jx(lambda: jlik.grad_log_marginal_likelihood(jc, *args_j)))
    for got, ref in zip(
            tlik.log_marginal_likelihood_and_all_grads(tc, *args_t),
            _jx(lambda: jlik.log_marginal_likelihood_and_all_grads(
                jc, *args_j))):
        _close(got, ref)
    _close(tlik.leave_one_out_log_likelihood(tc, *args_t),
           _jx(lambda: jlik.leave_one_out_log_likelihood(jc, *args_j)))
    hl = h * (0.7 + 0.6 * np.random.default_rng(5).random((3, 3)))
    _close(tlik.evaluate_log_likelihood_at_hyperparameter_list(
        kernel, _t(hl), *args_t),
        _jx(lambda: jlik.evaluate_log_likelihood_at_hyperparameter_list(
            kernel, jnp.asarray(hl), *args_j)))


# ---------------------------------------------------------------------------
# line search, Newton and the MAP fit (ops/optimizers.py, models/mcmc.py)
# ---------------------------------------------------------------------------

_A = np.array([[2.0, 0.6, 0.1], [0.6, 1.5, -0.3], [0.1, -0.3, 1.0]])
_C = np.array([0.3, -0.4, 0.8])


def _quadratic_j(x):
    d = x - jnp.asarray(_C)
    return -0.5 * d @ jnp.asarray(_A) @ d


def _quadratic_t(x):
    d = x - _t(_C)
    return -0.5 * d @ _t(_A) @ d


def _lml_objectives():
    """The LML over log hyperparameters (alpha, l1, l2, noise) of a fixed
    problem, in both packages."""
    x, y, _ = _problem(6)

    def f_j(th):
        h = jnp.exp(th)
        return jlik.log_marginal_likelihood(
            jcov.MaternNu2p5(hyperparameters=h[:3]), h[3:], x, y)

    def f_t(th):
        h = torch.exp(th)
        return tlik.log_marginal_likelihood(
            tcov.MaternNu2p5(hyperparameters=h[:3]), h[3:], _t(x), _t(y))

    return f_j, f_t, np.array([0.3, -0.5, -0.2, -3.0])


def _torch_vg(f):
    def vg(x):
        return f(x), torch.func.grad(f)(x)
    return vg


@pytest.mark.parametrize("objective", ["quadratic", "lml"])
def test_newton_and_line_search_match_jax(objective):
    if objective == "quadratic":
        f_j, f_t, x0 = _quadratic_j, _quadratic_t, np.array([-0.5, 0.5, 0.0])
        bound = 2.0
    else:
        f_j, f_t, x0 = _lml_objectives()
        bound = 5.0
    d = x0.shape[0]
    box = [[-bound, bound]] * d
    jd, td = jdom.TensorProductDomain.from_bounds(box), \
        tdom.TensorProductDomain.from_bounds(box)
    newton = dict(num_multistarts=1, max_num_steps=12, gamma=1.05,
                  time_factor=1e-2, max_relative_change=1.0)
    ls = dict(num_multistarts=1, max_num_steps=6, max_num_restarts=1,
              gamma=0.5, pre_mult=0.2, max_relative_change=0.5)
    _close(topt.newton_optimize(topt.value_and_grad(f_t), td, _t(x0),
                                topt.NewtonParameters(**newton)),
           _jx(lambda: jopt.newton_optimize(
               jax.value_and_grad(f_j), jd, jnp.asarray(x0),
               jopt.NewtonParameters(**newton))))
    _close(topt.gradient_ascent_line_search(
        _torch_vg(f_t), td, _t(x0), topt.GradientDescentParameters(**ls)),
        _jx(lambda: jopt.gradient_ascent_line_search(
            jax.value_and_grad(f_j), jd, jnp.asarray(x0),
            jopt.GradientDescentParameters(**ls))))


@pytest.mark.parametrize("winner", ["search", "gd"])
def test_dumb_search_fallback_matches_jax(winner):
    """Two GD starts and three search points on the quadratic: a search
    point at the optimum wins, or the GD's best does when none is near."""
    r = np.random.default_rng(7)
    starts = r.uniform(-1.5, -1.0, (2, 3))
    search = r.uniform(1.0, 1.5, (3, 3))
    if winner == "search":
        search[1] = _C
    box = [[-2.0, 2.0]] * 3
    params = dict(num_multistarts=2, max_num_steps=4, max_num_restarts=1,
                  num_steps_averaged=0, gamma=0.7, pre_mult=0.3,
                  max_relative_change=0.5)
    res_j = _jx(lambda: jopt.multistart_optimize_with_dumb_search_fallback(
        jax.value_and_grad(_quadratic_j),
        jdom.TensorProductDomain.from_bounds(box), jnp.asarray(starts),
        jnp.asarray(search), jopt.GradientDescentParameters(**params)))
    res_t = topt.multistart_optimize_with_dumb_search_fallback(
        _torch_vg(_quadratic_t), tdom.TensorProductDomain.from_bounds(box),
        _t(starts), _t(search), topt.GradientDescentParameters(**params))
    for got, ref in zip(res_t, res_j):
        _close(got, ref)
    took_search = bool(np.allclose(res_t.best_point.numpy(), _C))
    assert took_search == (winner == "search")


def _map_models(rng_seed=0):
    x, y, _ = _problem(8, n=20)
    jdata, tdata = JData(2), HistoricalData(2)
    jdata.append_historical_data(x, y)
    tdata.append_historical_data(x, y)
    kw = dict(bucket=16, n_hypers=8)
    return (jmcmc.GaussianProcessLogLikelihoodMCMC(
        jdata, rng_key=jax.random.PRNGKey(rng_seed), **kw),
        tmcmc.GaussianProcessLogLikelihoodMCMC(
            tdata, device="cpu", generator=torch.Generator().manual_seed(0),
            **kw))


def test_map_fit_matches_jax_and_launches_no_lml_kernel(monkeypatch):
    """optimize() from the same two starts (each package's prior draw
    replaced by them) in both packages: the same MAP member.  Then, with
    the LML kernel's gate forced open and the kernel replaced by a counting
    stand-in, the log posterior takes it while optimize() does not."""
    jm, tm = _map_models()
    starts = np.array([[0.2, -0.6, -0.4, -2.5], [-0.3, 0.1, 0.3, -4.0]])
    monkeypatch.setattr(type(jm.prior), "sample_from_prior",
                        lambda self, key, n: jnp.asarray(starts[:n]))
    monkeypatch.setattr(
        type(tm.prior), "sample_from_prior",
        lambda self, g, n, device=None, dtype=None: _t(starts[:n]))
    jm.optimize(num_restarts=2)
    tm.optimize(num_restarts=2)
    _close(tm.hypers, jm.hypers)
    _close(tm.models.K_inv_y[0], jmcmc.ensemble_member(jm.models, 0).K_inv_y)
    assert tm.num_mcmc == jm.num_mcmc == 1 and tm.is_trained
    assert bool(torch.isfinite(tm.map_values).all())
    _close(tm.compute_log_likelihood(tm.hypers[0]),
           jm.compute_log_likelihood(jnp.asarray(jm.hypers[0])))

    def counting_lml(*args):
        tlog.count("kernels.lml_fused")
        return kernels.lml_fused_plain(*args)

    monkeypatch.setattr(tmcmc, "uses_lml_kernel", lambda *a: True)
    monkeypatch.setattr(kernels, "lml_fused", counting_lml)
    before = tlog.counters()
    tm.compute_log_likelihood(tm.hypers[0])
    assert tlog.growth(before).get("kernels.lml_fused", 0) == 1
    tm.optimize(num_restarts=1)
    assert tlog.growth(before).get("kernels.lml_fused", 0) == 1


@pytest.mark.parametrize("hessian", ["value_part", "explicit"])
def test_newton_contract_matches_jax_on_the_map_problem(hessian):
    """``newton_optimize(value_and_grad_fn, domain, x0, params,
    hessian_fn=None)``, the JAX package's contract, on the MAP fit's
    problem (its log posterior, domain, Newton parameters and first start):
    the Hessian of the value part (``torch.func.hessian`` through
    ``value_and_grad``) or an explicit ``hessian_fn``, against the JAX
    package's ``newton_optimize`` from the same start."""
    jm, tm = _map_models()
    x0 = np.array([0.2, -0.6, -0.4, -2.5])
    jdata, tdata = jm._padded_data(), tm._padded_data()
    jlp = jm._log_posterior_with_data()

    def f_t(t):
        return tm.log_posterior(t[None], *tdata, force_plain=True)[0]

    def vg_j(t):
        return jax.value_and_grad(lambda tt: jlp(tt[None], *jdata)[0])(t)

    bound = tmcmc.LOG_BOUND - 1e-3
    box = [[-bound, bound]] * 4
    params = dict(num_multistarts=1, max_num_steps=40, gamma=1.05,
                  time_factor=1e-2, max_relative_change=1.0)
    kw = {} if hessian == "value_part" else dict(
        hessian_fn=torch.func.hessian(f_t))
    got = topt.newton_optimize(
        topt.value_and_grad(f_t), tdom.TensorProductDomain.from_bounds(box),
        _t(x0), topt.NewtonParameters(**params), **kw)
    ref = _jx(lambda: jopt.newton_optimize(
        vg_j, jdom.TensorProductDomain.from_bounds(box), jnp.asarray(x0),
        jopt.NewtonParameters(**params)))
    assert bool(torch.isfinite(got).all())
    _close(got, ref)


# 40 Branin values, on which the Newton steps from these starts leave the
# Tophat prior's support; start 1's log posterior is above start 0's
BRANIN_STARTS = np.array([[-0.29, -1.11, -0.24, -4.2],
                          [1.54, 1.23, 1.96, -3.59]])


def _branin_map_models():
    f = tsf.Branin()
    box = f._search_domain
    x = box[:, 0] + np.random.default_rng(0).random((40, 2)) * (
        box[:, 1] - box[:, 0])
    y = [f.evaluate_true(p)[0] for p in x]
    jdata, tdata = JData(2), HistoricalData(2)
    jdata.append_historical_data(x, y)
    tdata.append_historical_data(x, y)
    kw = dict(bucket=16, n_hypers=8, standardize=True)
    return (jmcmc.GaussianProcessLogLikelihoodMCMC(
        jdata, rng_key=jax.random.PRNGKey(0), **kw),
        tmcmc.GaussianProcessLogLikelihoodMCMC(
            tdata, device="cpu", generator=torch.Generator().manual_seed(0),
            **kw))


def _given_starts(monkeypatch, jm, tm, starts):
    """Each package's prior draw replaced by ``starts`` (this test only)."""
    monkeypatch.setattr(type(jm.prior), "sample_from_prior",
                        lambda self, key, n: jnp.asarray(starts[:n]))
    monkeypatch.setattr(
        type(tm.prior), "sample_from_prior",
        lambda self, g, n, device=None, dtype=None: _t(starts[:n]))


def test_map_fit_falls_back_to_start_0(monkeypatch):
    """On 40 Branin values the log length scales climb past the Tophat
    prior's bound (3) during the Newton steps, where the log posterior is
    -inf: no end is finite, and start 0 stands as drawn, as in the JAX
    package, though start 1's log posterior is higher."""
    _, tm = _branin_map_models()
    starts = BRANIN_STARTS
    monkeypatch.setattr(
        type(tm.prior), "sample_from_prior",
        lambda self, g, n, device=None, dtype=None: _t(starts[:n]))
    tm.optimize(num_restarts=2)
    assert not bool(torch.isfinite(tm.map_values).any())
    lp = [float(tm.compute_log_likelihood(s_)) for s_ in starts]
    assert np.isfinite(lp).all() and lp[1] > lp[0]
    np.testing.assert_array_equal(tm.hypers[0], starts[0])


@pytest.mark.parametrize("second_start, end_finite", [
    (BRANIN_STARTS[1], False), ([0.5, -1.0, -1.0, -3.0], True)],
    ids=["no_finite_end", "one_finite_end"])
def test_map_fit_pick_matches_jax(monkeypatch, second_start, end_finite):
    """optimize() on the 40 Branin values from the same two starts in both
    packages, start 0 one whose Newton end leaves the Tophat support.
    When start 1's end leaves it too, no end is finite and both keep start
    0 bit for bit; when start 1's end is finite, both take that end, held
    to each other at ``TOL``, the MAP tolerance of
    :func:`test_map_fit_matches_jax_and_launches_no_lml_kernel`."""
    jm, tm = _branin_map_models()
    starts = np.array([BRANIN_STARTS[0], second_start])
    _given_starts(monkeypatch, jm, tm, starts)
    jm.optimize(num_restarts=2)
    tm.optimize(num_restarts=2)
    finite = torch.isfinite(tm.map_values).numpy()
    assert not finite[0] and finite[1] == end_finite
    if end_finite:
        assert not np.allclose(tm.hypers[0], starts[1])
        _close(tm.hypers, jm.hypers)
    else:
        np.testing.assert_array_equal(np.asarray(jm.hypers)[0], starts[0])
        np.testing.assert_array_equal(tm.hypers[0], starts[0])


def test_mcmc_model_surface():
    _, tm = _map_models()
    assert not tm.is_trained and tm.num_mcmc == 0
    tm.burnin_steps, tm.chain_length = 10, 10
    tm.train()
    assert tm.is_trained and tm.num_mcmc == tmcmc.ensemble_size(tm.models) \
        == tm.n_hypers


# ---------------------------------------------------------------------------
# domains (ops/domains.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mrc", [1.0, 0.4])
def test_simplex_and_dummy_domains_match_jax(mrc):
    r = np.random.default_rng(9)
    box = [[-0.2, 0.8], [0.1, 1.5], [0.0, 0.6]]
    js = jdom.SimplexIntersectTensorProductDomain.from_bounds(box)
    ts = tdom.SimplexIntersectTensorProductDomain.from_bounds(box)
    _close(ts.tensor_product_domain.bounds, js.tensor_product_domain.bounds)
    assert ts.dim == js.dim == 3
    pts = r.uniform(-0.3, 1.2, (40, 3))
    steps = r.normal(0.0, 0.4, (40, 3))
    inside = np.asarray(js.clip(jnp.asarray(pts)))
    assert np.array_equal(ts.check_point_inside(_t(pts)).numpy(),
                          np.asarray(js.check_point_inside(jnp.asarray(pts))))
    _close(ts.clip(_t(pts)), inside)
    _close(ts.limit_update(mrc, _t(inside), _t(steps)),
           js.limit_update(mrc, jnp.asarray(inside), jnp.asarray(steps)))
    drawn = ts.generate_uniform_random_points_in_domain(
        torch.Generator().manual_seed(0), 50)
    assert drawn.shape == (50, 3) and bool(ts.check_point_inside(drawn).all())

    jd, td = jdom.DummyDomain(), tdom.DummyDomain()
    assert np.array_equal(td.check_point_inside(_t(pts)).numpy(),
                          np.asarray(jd.check_point_inside(jnp.asarray(pts))))
    _close(td.clip(_t(pts)), jd.clip(jnp.asarray(pts)))
    _close(td.limit_update(mrc, _t(pts), _t(steps)),
           jd.limit_update(mrc, jnp.asarray(pts), jnp.asarray(steps)))
    _close(tdom.tensor_product_domain(box).bounds,
           jdom.tensor_product_domain(box).bounds)


# ---------------------------------------------------------------------------
# checkpoints (utils/checkpoint.py)
# ---------------------------------------------------------------------------

def _data(rng, n=10):
    data = HistoricalData(dim=1)
    x = np.sort(rng.random(n) * 4 - 2)[:, None]
    data.append_historical_data(x, np.sin(2 * x[:, 0]))
    return data


def test_checkpoint_roundtrip(tmp_path, rng):
    data = _data(rng)
    path = str(tmp_path / "run.ckpt")
    g = torch.Generator().manual_seed(3)
    tck.save_checkpoint(path, data, generator=g,
                        metadata={"iteration": 7, "method": "EI"})
    assert not (tmp_path / "run.ckpt.tmp.npz").exists()
    data2, manifest, arrays = tck.load_checkpoint(path)
    assert manifest["metadata"] == {"iteration": 7, "method": "EI"}
    assert manifest["format_version"] == tck.FORMAT_VERSION == 1
    np.testing.assert_array_equal(data2.points_sampled, data.points_sampled)
    np.testing.assert_array_equal(data2.points_sampled_value,
                                  data.points_sampled_value)
    np.testing.assert_array_equal(arrays["torch_generator_state"],
                                  g.get_state().numpy())


def test_checkpoint_rejects_newer_format(tmp_path, rng):
    path = str(tmp_path / "v.ckpt")
    tck.save_checkpoint(path, _data(rng))
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    manifest = dict(__import__("json").loads(bytes(arrays["manifest"])))
    manifest["format_version"] = tck.FORMAT_VERSION + 1
    arrays["manifest"] = np.frombuffer(
        __import__("json").dumps(manifest).encode(), dtype=np.uint8)
    with open(path, "wb") as f:
        np.savez(f, **arrays)
    with pytest.raises(ValueError, match="newer"):
        tck.load_checkpoint(path)


def test_checkpoint_resumes_mcmc_without_burnin(tmp_path, rng):
    """The restored model skips burn-in and continues the chain: its next
    train() equals the saved model's next train() bit for bit."""
    data = _data(rng)
    model = tmcmc.GaussianProcessLogLikelihoodMCMC(
        data, chain_length=25, burnin_steps=25, n_hypers=8, noisy=False,
        device="cpu", generator=torch.Generator().manual_seed(0))
    model.train()
    path = str(tmp_path / "mcmc.ckpt")
    tck.save_checkpoint(path, data, mcmc_model=model,
                        generator=model.generator)
    restored, manifest = tck.restore_mcmc_model(path, device="cpu")
    assert restored.burned and restored.is_trained
    assert tmcmc.ensemble_size(restored.models) == \
        tmcmc.ensemble_size(model.models)
    assert torch.equal(restored.p0, model.p0)
    assert torch.equal(restored.models.chol_K, model.models.chol_K)
    model.train()
    restored.train()
    assert torch.equal(restored.p0, model.p0)
    np.testing.assert_array_equal(restored.hypers, model.hypers)


def test_checkpoint_restores_derivatives_and_bucket(tmp_path, rng):
    n, dim = 6, 2
    data = HistoricalData(dim=dim, num_derivatives=dim)
    x = rng.random((n, dim))
    y = np.stack([np.sin(x[:, 0]), np.cos(x[:, 0]), -np.sin(x[:, 1])],
                 axis=1)
    data.append_historical_data(x, y)
    model = tmcmc.GaussianProcessLogLikelihoodMCMC(
        data, derivatives=(0, 1), chain_length=10, burnin_steps=10,
        n_hypers=8, noisy=False, bucket=4, standardize=True,
        chain_gate_tol=0.5, device="cpu",
        generator=torch.Generator().manual_seed(0))
    model.train()
    path = str(tmp_path / "dkg.ckpt")
    tck.save_checkpoint(path, data, mcmc_model=model)
    restored, _ = tck.restore_mcmc_model(path, device="cpu")
    assert restored.derivatives == (0, 1) and restored.bucket == 4
    assert restored.standardize and restored.chain_gate_tol == 0.5
    assert restored.is_trained
    assert restored.models.chol_K.shape == model.models.chol_K.shape
    restored.train()
    assert restored.is_trained


def test_port_reads_a_jax_checkpoint(tmp_path):
    """A checkpoint the JAX package wrote: the data, the walker positions
    and the hyperparameter samples carry over, and the port's refit of the
    samples matches the JAX restored model's states.  The threefry keys
    are ignored: the generator is seeded from the caller's seed."""
    x, y, _ = _problem(12, n=20)
    data = JData(2)
    data.append_historical_data(x, y)
    jm = jmcmc.GaussianProcessLogLikelihoodMCMC(
        data, n_hypers=8, bucket=16, standardize=True, chain_gate_tol=1.0,
        rng_key=jax.random.PRNGKey(0))
    r = np.random.default_rng(13)
    jm.p0 = jnp.asarray(r.normal([0.0, -0.8, -0.8, -3.0], 0.2, (8, 4)))
    jm.hypers = np.asarray(jm.p0)[r.integers(0, 8, 4)]
    jm.burned = True
    path = str(tmp_path / "jax.ckpt")
    jck.save_checkpoint(path, data, mcmc_model=jm,
                        rng_key=jax.random.PRNGKey(1),
                        metadata={"iteration": 2})
    jrest, _ = jck.restore_mcmc_model(path)
    trest, manifest = tck.restore_mcmc_model(path, device="cpu", seed=5)
    assert manifest["metadata"] == {"iteration": 2}
    np.testing.assert_array_equal(trest._data.points_sampled, x)
    np.testing.assert_array_equal(trest.p0.numpy(), np.asarray(jm.p0))
    np.testing.assert_array_equal(trest.hypers, jm.hypers)
    assert trest.burned and trest.standardize and trest.bucket == 16
    assert torch.equal(trest.generator.get_state(),
                       torch.Generator().manual_seed(5).get_state())
    got = convert.gp_state_to_arrays(trest.models)
    for name in convert.GP_STATE_FIELDS:
        ref = jrest.models.covariance.hyperparameters if \
            name == "hyperparameters" else getattr(jrest.models, name)
        _close(got[name], ref, err_msg=name, **TOL)


# ---------------------------------------------------------------------------
# synthetic objectives, logging, HeSBO (utils/)
# ---------------------------------------------------------------------------

MINIMIZERS = {
    "Branin": [np.pi, 2.275], "BraninNoisy": [np.pi, 2.275],
    "BraninWithDerivatives": [np.pi, 2.275],
    "BraninFidelity": [np.pi, 2.275, 1.0],
    "Hartmann6": [0.20169, 0.150011, 0.476874, 0.275332, 0.311652, 0.6573],
    "Hartmann6WithDerivatives": [0.20169, 0.150011, 0.476874, 0.275332,
                                 0.311652, 0.6573],
    "Hartmann3": [0.114614, 0.555649, 0.852547],
    "Rosenbrock": [1.0, 1.0], "Levy4": [1.0] * 4, "Ackley": [0.0] * 5}


@pytest.mark.parametrize("name", list(jsf.SYNTHETIC_FUNCTIONS))
def test_synthetic_functions_match_jax(name):
    """Value and gradient at seeded points, the domain and the settings,
    the noisy draws of evaluate(), and the value at the minimizer."""
    assert sorted(tsf.SYNTHETIC_FUNCTIONS) == sorted(jsf.SYNTHETIC_FUNCTIONS)
    fj, ft = jsf.SYNTHETIC_FUNCTIONS[name](), tsf.SYNTHETIC_FUNCTIONS[name]()
    for attr in ("_dim", "_num_init_pts", "_sample_var", "_min_value",
                 "_num_fidelity"):
        assert getattr(ft, attr) == getattr(fj, attr), attr
    assert tuple(ft._observations) == tuple(fj._observations)
    np.testing.assert_array_equal(ft._search_domain, fj._search_domain)
    box = fj._search_domain
    for x in box[:, 0] + np.random.default_rng(14).random(
            (4, fj._dim)) * (box[:, 1] - box[:, 0]):
        _close(ft.evaluate_true(x), fj.evaluate_true(x), rtol=1e-12,
               atol=1e-12)
        _close(ft.evaluate(x), fj.evaluate(x), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(
        ft.evaluate_true(np.array(MINIMIZERS[name]))[0], fj._min_value,
        atol=1e-4)


def test_logging_helpers(tmp_path, caplog):
    saved = tlog.logger.handlers[:], tlog.logger.level
    try:
        log = tlog.configure_logging(verbose=True)
        assert log.level == logging.DEBUG and len(log.handlers) == 1
        with caplog.at_level(logging.DEBUG, logger=tlog.LOGGER_NAME):
            tlog.error_printf("e %d", 1)
            tlog.warning_printf("w %d", 2)
            tlog.verbose_printf("v %d", 3)
            tlog.print_matrix(torch.eye(2), "eye")
        assert [r.getMessage().split("\n")[0] for r in caplog.records] == \
            ["e 1", "w 2", "v 3", "eye ="]
        assert tlog.configure_logging().level == logging.INFO
    finally:
        tlog.logger.handlers[:], _ = saved
        tlog.logger.setLevel(saved[1])
    with tlog.device_trace(str(tmp_path / "trace")) as out:
        torch.ones(3).sum()
    assert (tmp_path / "trace" / "trace.json").exists() and \
        out == str(tmp_path / "trace")


@pytest.mark.parametrize("seed", [0, 3])
def test_hesbo_projection_matches_jax(seed):
    fj, ft = jsf.Hartmann6(), tsf.Hartmann6()
    pj, pt = jhesbo.Projection(2, fj, seed=seed), \
        thesbo.Projection(2, ft, seed=seed)
    np.testing.assert_array_equal(pt._high_to_low, pj._high_to_low)
    np.testing.assert_array_equal(pt._sign, pj._sign)
    np.testing.assert_array_equal(pt._search_domain, pj._search_domain)
    for x in np.random.default_rng(seed).random((3, 2)):
        np.testing.assert_array_equal(pt.back_projection(x),
                                      pj.back_projection(x))
        _close(pt.evaluate_true(x), pj.evaluate_true(x), rtol=1e-12,
               atol=1e-12)
    assert thesbo.projection is thesbo.Projection
