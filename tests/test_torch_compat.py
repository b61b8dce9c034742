"""The port's compatibility layer (``cornell_moe_tpu_torch.compat``) against
the JAX package's (``cornell_moe_tpu.compat``), in float64 on the CPU, and
the port's ``exceptions``, ``utils/constant``, ``utils/geometry`` and
``utils/rng``.

Both packages' objects are built from the same numpy inputs (n <= 12
points, 3 members, <= 16 MC draws); the port's models and MC normals come
from the JAX objects through ``convert`` (``compat_model_to_arrays`` /
``compat_model_from_arrays``, ``carry_normals``).  Where a compat call
draws its own starts, its deterministic core is held to the JAX package's
with the same starts given to both, and the call itself to the properties
tests/test_compat_api.py checks: shape, inside the domain, no worse than
its start, a point list equal to point-by-point evaluation at rtol 1e-10.

Tolerances: the covariance at rtol 1e-12; the domains exactly; the GP
posterior, its gradients and its Cholesky variance, the LML and LOO
values, gradients and hyperparameter lists, EI (analytic and MC on the
same normals) and PosteriorMean(MCMC) at rtol 1e-10 (atol 1e-13); KG and
KG-MCMC values and gradients at rtol 1e-7 / atol 1e-9
(tests/test_knowledge_gradient.py:50); optimizer endpoints from the same
starts at rtol 1e-8 / atol 1e-10; the constant liar's estimate exactly and
the kriging believer's mu + c sigma at rtol 1e-12 (a posterior computed
through two BLAS libraries).  The JAX side runs its classes' own
``value_and_grad_jax`` hook under ``jax.jit`` where a method would run
eagerly for seconds.
"""

import logging

import jax
import numpy as np
import pytest
import torch

from cornell_moe_tpu.compat import covariance as jcov_c
from cornell_moe_tpu.compat import domain as jdom_c
from cornell_moe_tpu.compat import estimation_policies as jpol
from cornell_moe_tpu.compat import expected_improvement as jei_c
from cornell_moe_tpu.compat import expected_improvement_mcmc as jeim_c
from cornell_moe_tpu.compat import gaussian_process as jgp_c
from cornell_moe_tpu.compat import knowledge_gradient as jkg_c
from cornell_moe_tpu.compat import knowledge_gradient_mcmc as jkgm_c
from cornell_moe_tpu.compat import log_likelihood as jlik_c
from cornell_moe_tpu.compat import optimization as jopt_c
from cornell_moe_tpu.compat.repeated_domain import RepeatedDomain as JRepC
from cornell_moe_tpu.ops import optimizers as jopt
from cornell_moe_tpu.utils import geometry as jgeo
from cornell_moe_tpu.utils.data_containers import HistoricalData as JData
from cornell_moe_tpu_torch import convert
from cornell_moe_tpu_torch import exceptions as texc
from cornell_moe_tpu_torch.compat import covariance as tcov_c
from cornell_moe_tpu_torch.compat._boundary import value_and_grad_by_autograd
from cornell_moe_tpu_torch.compat import domain as tdom_c
from cornell_moe_tpu_torch.compat import estimation_policies as tpol
from cornell_moe_tpu_torch.compat import expected_improvement as tei_c
from cornell_moe_tpu_torch.compat import expected_improvement_mcmc as teim_c
from cornell_moe_tpu_torch.compat import gaussian_process as tgp_c
from cornell_moe_tpu_torch.compat import knowledge_gradient as tkg_c
from cornell_moe_tpu_torch.compat import knowledge_gradient_mcmc as tkgm_c
from cornell_moe_tpu_torch.compat import log_likelihood as tlik_c
from cornell_moe_tpu_torch.compat import log_likelihood_mcmc as tllm_c
from cornell_moe_tpu_torch.compat import misc as tmisc
from cornell_moe_tpu_torch.compat import optimization as topt_c
from cornell_moe_tpu_torch.compat.repeated_domain import RepeatedDomain \
    as TRepC
from cornell_moe_tpu_torch.models import gp as tgp
from cornell_moe_tpu_torch.models import mcmc as tmcmc
from cornell_moe_tpu_torch.ops import optimizers as topt
from cornell_moe_tpu_torch.utils import constant as tconst
from cornell_moe_tpu_torch.utils import geometry as tgeo
from cornell_moe_tpu_torch.utils.data_containers import HistoricalData \
    as TData
from cornell_moe_tpu_torch.utils.rng import RandomnessSourceContainer

torch.set_num_threads(1)
CPU = dict(device="cpu")
COV = dict(rtol=1e-12, atol=1e-14)
VAL = dict(rtol=1e-10, atol=1e-13)
KG = dict(rtol=1e-7, atol=1e-9)
ENDS = dict(rtol=1e-8, atol=1e-10)
N, S, M = 10, 3, 16
HYPERS = [1.1, 0.6, 0.8]
BOX = [(-1.0, 1.0), (-1.0, 1.0)]
INNER = dict(num_multistarts=1, max_num_steps=4, max_num_restarts=1,
             num_steps_averaged=2, gamma=0.0, pre_mult=1.0,
             max_relative_change=0.1)
OUTER = dict(num_multistarts=3, max_num_steps=3, max_num_restarts=1,
             gamma=0.7, pre_mult=0.4, max_relative_change=0.5)


def _close(got, ref, tol, err_msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               err_msg=err_msg, **tol)


def _data(cls, num_derivatives=0, seed=0, n=N):
    r = np.random.default_rng(seed)
    x = r.random((n, 2)) * 2 - 1
    y = np.sin(2 * x[:, 0]) + x[:, 1] ** 2
    vals = y[:, None] if not num_derivatives else \
        np.stack([y, 2 * np.cos(2 * x[:, 0])], axis=1)
    data = cls(dim=2, num_derivatives=num_derivatives)
    data.append_historical_data(x, vals)
    return data


def _port(j_model):
    return convert.compat_model_from_arrays(
        convert.compat_model_to_arrays(j_model), dtype=torch.float64, **CPU)


def _doms():
    return (jdom_c.TensorProductDomain(BOX),
            tdom_c.TensorProductDomain(BOX, **CPU))


@pytest.fixture(scope="module")
def gps():
    """A value-only GP and one observing d/dx_0, JAX and port."""
    out = {}
    for kind, nd in (("value", 0), ("derivative", 1)):
        j = jgp_c.GaussianProcess(jcov_c.MaternNu2p5(HYPERS),
                                  [1e-3] * (1 + nd), _data(JData, nd),
                                  derivatives=(0,) * nd)
        out[kind] = (j, _port(j))
    return out


@pytest.fixture(scope="module")
def ensemble():
    r = np.random.default_rng(4)
    hypers = np.concatenate([0.8 + r.random((S, 1)),
                             0.4 + 0.4 * r.random((S, 2))], axis=1)
    j = jkgm_c.GaussianProcessMCMC(hypers, np.full((S, 1), 1e-3),
                                   _data(JData))
    return j, _port(j)


PTS = np.array([[0.3, -0.2], [-0.5, 0.6], [0.1, 0.1]])


# ---------------------------------------------------------------------------
# covariance, domains
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("what", ["covariance", "grad_covariance",
                                  "hyperparameter_grad_covariance"])
@pytest.mark.parametrize("kernel", ["SquareExponential", "MaternNu2p5"])
def test_covariance_matches_jax(kernel, what):
    j = getattr(jcov_c, kernel)([2.0, 0.5, 1.5])
    t = getattr(tcov_c, kernel)([2.0, 0.5, 1.5], **CPU)
    assert t.num_hyperparameters == 3 and t.covariance_type == \
        j.covariance_type
    x, y = np.array([0.3, -0.4]), np.array([-0.1, 0.7])
    _close(getattr(t, what)(x, y), getattr(j, what)(x, y), COV)
    t.set_hyperparameters([1.0, 1.0, 1.0])
    assert t.covariance(x, x) == pytest.approx(1.0)


@pytest.mark.parametrize("kind", ["tensor_product", "simplex", "repeated"])
def test_domain_checks_and_update_match_jax(kind):
    """Point checks and the restricted update, exactly; the port's
    Latin-hypercube points lie inside."""
    bounds = [(0.0, 1.0), (-1.0, 1.0)] if kind != "simplex" else \
        [(0.0, 1.0)] * 2
    if kind == "simplex":
        j = jdom_c.SimplexIntersectTensorProductDomain(bounds)
        t = tdom_c.SimplexIntersectTensorProductDomain(bounds, **CPU)
    else:
        j = jdom_c.TensorProductDomain(bounds)
        t = tdom_c.TensorProductDomain(bounds, **CPU)
    assert t._domain_type == j._domain_type and t.dim == 2
    r = np.random.default_rng(1)
    pts = r.random((8, 2)) * 2.2 - 0.6
    steps = r.standard_normal((8, 2))
    if kind == "repeated":
        j, t = JRepC(2, j), TRepC(2, t)
        pts, steps = pts.reshape(4, 2, 2), steps.reshape(4, 2, 2)
        starts = t.generate_latin_hypercube_points(5)
        assert starts.shape == (5, 2, 2) and all(
            t.check_point_inside(b) for b in starts)
    elif kind == "tensor_product":
        starts = t.generate_latin_hypercube_points(20)
        assert starts.shape == (20, 2) and all(
            t.check_point_inside(p) for p in starts)
    for p, step in zip(pts, steps):
        assert t.check_point_inside(p) == j.check_point_inside(p)
        inside = np.clip(p, 0.05, 0.45) if kind == "simplex" else \
            np.clip(p, [0.0, -1.0], [1.0, 1.0])
        np.testing.assert_array_equal(
            t.compute_update_restricted_to_domain(0.5, inside, step),
            np.asarray(j.compute_update_restricted_to_domain(0.5, inside,
                                                             step)))


# ---------------------------------------------------------------------------
# GaussianProcess
# ---------------------------------------------------------------------------

GP_QUANTITIES = ["compute_mean_of_points", "compute_variance_of_points",
                 "compute_cholesky_variance_of_points",
                 "compute_grad_mean_of_points",
                 "compute_grad_variance_of_points",
                 "compute_grad_cholesky_variance_of_points"]


@pytest.mark.parametrize("quantity", GP_QUANTITIES)
@pytest.mark.parametrize("kind", ["value", "derivative"])
def test_gaussian_process_matches_jax(gps, kind, quantity):
    j, t = gps[kind]
    assert (t.dim, t.num_sampled, t.derivatives) == \
        (j.dim, j.num_sampled, j.derivatives)
    got = getattr(t, quantity)(PTS[:2])
    ref = np.asarray(getattr(j, quantity)(PTS[:2]))
    assert got.shape == ref.shape
    _close(got, ref, VAL)


def test_gaussian_process_updates_and_draws(gps):
    """add_sampled_points refits both to the same posterior; the draws
    are finite and of their shapes; the copies are deep."""
    from cornell_moe_tpu.utils.data_containers import SamplePoint as JPoint
    from cornell_moe_tpu_torch.utils.data_containers import SamplePoint

    j0, _ = gps["value"]
    j = jgp_c.GaussianProcess(jcov_c.MaternNu2p5(HYPERS), [1e-3],
                              j0.get_historical_data_copy())
    t = _port(j)
    j.add_sampled_points([JPoint(np.array([0.2, 0.4]), [0.5], 0.0)])
    t.add_sampled_points([SamplePoint(np.array([0.2, 0.4]), [0.5], 0.0)])
    assert t.num_sampled == N + 1
    _close(t.compute_mean_of_points(PTS), j.compute_mean_of_points(PTS),
           VAL)
    assert np.isfinite(t.sample_point_from_gp(PTS[0], noise_variance=0.01))
    optima = t.sample_global_optima(3, domain_bounds=BOX, num_grid=30,
                                    n_features=100)
    assert optima.shape == (3, 2) and np.all(np.abs(optima) <= 1.0)
    cov, data = t.get_core_data_copy()
    assert data.num_sampled == N + 1 and data is not t._historical_data
    assert np.array_equal(cov.hyperparameters, HYPERS)


@pytest.mark.parametrize("case", ["duplicate_points", "linalg_error",
                                  "cholesky_variance", "check_finite"])
def test_singular_matrix_error(monkeypatch, case):
    """SingularMatrixError where the JAX package raises it: a NaN factor
    (duplicate points with zero noise), and here also torch's own
    LinAlgError from a factorization; a singular posterior variance; and
    check_finite_cholesky on a tensor and on an array."""
    data = TData(dim=1)
    data.append_historical_data(np.array([[0.5], [0.5]]),
                                np.array([1.0, 1.0]))
    cov = tcov_c.SquareExponential([1.0, 1.0], **CPU)
    if case == "duplicate_points":
        jdata = JData(dim=1)
        jdata.append_historical_data(np.array([[0.5], [0.5]]),
                                     np.array([1.0, 1.0]))
        with pytest.raises(Exception) as ref:
            jgp_c.GaussianProcess(jcov_c.SquareExponential([1.0, 1.0]),
                                  [0.0], jdata)
        assert type(ref.value).__name__ == "SingularMatrixError"
        with pytest.raises(texc.SingularMatrixError):
            tgp_c.GaussianProcess(cov, [0.0], data)
    elif case == "linalg_error":
        def refuse(*args, **kwargs):
            raise torch.linalg.LinAlgError("not positive definite")
        monkeypatch.setattr(tgp, "fit_gp", refuse)
        with pytest.raises(texc.SingularMatrixError):
            tgp_c.GaussianProcess(cov, [1e-2], data)
    elif case == "cholesky_variance":
        # zero posterior variance at the one noiseless sampled point
        one = TData(dim=1)
        one.append_historical_data(np.array([[0.5]]), np.array([1.0]))
        gp = tgp_c.GaussianProcess(cov, [0.0], one)
        assert gp.compute_variance_of_points(np.array([[0.5]]))[0, 0] == 0
        with pytest.raises(texc.SingularMatrixError):
            gp.compute_cholesky_variance_of_points(np.array([[0.5]]))
    else:
        bad = torch.tensor([[1.0, 0.0], [float("nan"), 1.0]])
        for chol in (bad, bad.numpy()):
            with pytest.raises(texc.SingularMatrixError) as err:
                texc.check_finite_cholesky(chol, "here")
            assert isinstance(err.value.matrix, np.ndarray)
        good = torch.eye(2)
        assert texc.check_finite_cholesky(good, "here") is good
    assert issubclass(texc.SingularMatrixError, texc.OptimalLearningError)


def test_singular_matrix_error_in_float32():
    """Duplicate points with zero noise in float32: the JAX class (x64
    off) fits with no jitter and raises SingularMatrixError, and so does
    the port, whose fit adds no jitter in float32 either."""
    x, y = np.array([[0.5], [0.5]]), np.array([1.0, 1.0])
    jdata = JData(dim=1)
    jdata.append_historical_data(x, y)
    with jax.enable_x64(False):
        with pytest.raises(Exception) as ref:
            jgp_c.GaussianProcess(jcov_c.SquareExponential([1.0, 1.0]),
                                  [0.0], jdata)
    assert type(ref.value).__name__ == "SingularMatrixError"
    data = TData(dim=1)
    data.append_historical_data(x, y)
    cov = tcov_c.SquareExponential([1.0, 1.0], device="cpu",
                                   dtype=torch.float32)
    with pytest.raises(texc.SingularMatrixError):
        tgp_c.GaussianProcess(cov, [0.0], data)


def test_exception_payloads():
    err = texc.BoundsError("out", value=3.0, min_bound=0.0, max_bound=1.0)
    assert (err.value, err.min_bound, err.max_bound) == (3.0, 0.0, 1.0)
    assert "bounds=[0.0, 1.0]" in str(err)
    err = texc.InvalidValueError("bad", value=2, truth=1)
    assert (err.value, err.truth) == (2, 1) and "expected=1" in str(err)


# ---------------------------------------------------------------------------
# log likelihoods
# ---------------------------------------------------------------------------

LIKELIHOODS = {"lml": "GaussianProcessLogMarginalLikelihood",
               "loo": "GaussianProcessLeaveOneOutLogLikelihood"}


def _likelihoods(measure):
    j = getattr(jlik_c, LIKELIHOODS[measure])(
        jcov_c.MaternNu2p5([1.0, 0.7, 0.9]), _data(JData),
        noise_variance=[1e-2])
    t = getattr(tlik_c, LIKELIHOODS[measure])(
        tcov_c.MaternNu2p5([1.0, 0.7, 0.9], **CPU), _data(TData),
        noise_variance=[1e-2])
    return j, t


@pytest.mark.parametrize("quantity", ["value", "grad", "list"])
@pytest.mark.parametrize("measure", list(LIKELIHOODS))
def test_log_likelihood_matches_jax(measure, quantity):
    j, t = _likelihoods(measure)
    assert t.objective_type == j.objective_type and t.problem_size == 3
    if quantity == "value":
        _close(t.compute_log_likelihood(), j.compute_log_likelihood(), VAL)
    elif quantity == "grad":
        _close(t.compute_grad_log_likelihood(),
               j.compute_grad_log_likelihood(), VAL)
    else:
        hl = np.abs(np.random.default_rng(2).standard_normal((4, 3))) + 0.5
        status = {}
        got = tlik_c.evaluate_log_likelihood_at_hyperparameter_list(
            t, hl, status=status)
        assert got.shape == (4,) and status[
            "evaluated_log_likelihood_at_hyperparameter_list"]
        _close(got, jlik_c.evaluate_log_likelihood_at_hyperparameter_list(
            j, hl), VAL)


def test_hyperparameter_optimization_matches_jax_from_the_same_starts():
    """The multistart over log-hyperparameters from given starts (its
    deterministic core) in both packages; then the port's entry points:
    the fit never lowers the LML, and the Newton polish never lowers the
    multistart's."""
    j, t = _likelihoods("lml")
    params = dict(num_multistarts=3, max_num_steps=15, max_num_restarts=1,
                  gamma=0.7, pre_mult=0.2, max_relative_change=0.5)
    starts = np.random.default_rng(3).random((3, 3)) * 2 - 1
    bounds = [(-3.0, 3.0)] * 3

    def jvg(lh):
        return jax.value_and_grad(
            lambda x: j.value_and_grad_jax(jax.numpy.exp(x))[0])(lh)

    ref = jopt.multistart_optimize(
        jvg, jdom_c.TensorProductDomain(bounds).core, jax.numpy.asarray(
            starts), jopt.GradientDescentParameters(**params))
    log_value = tlik_c._log_objective(t)
    got = topt.multistart_optimize(
        lambda lh: value_and_grad_by_autograd(log_value, lh),
        tdom_c.TensorProductDomain(bounds, **CPU).core,
        torch.as_tensor(starts), topt.GradientDescentParameters(**params))
    _close(got.all_points, ref.all_points, ENDS)
    _close(got.all_values, ref.all_values, ENDS)

    v0 = t.compute_log_likelihood()
    optimizer = topt_c.GradientDescentOptimizer(
        tdom_c.TensorProductDomain(bounds, **CPU), t,
        topt_c.GradientDescentParameters(**params))
    status = {}
    best = tlik_c.multistart_hyperparameter_optimization(optimizer,
                                                         status=status)
    assert best.shape == (3,) and status["log_likelihood_found_update"]
    v1 = t.compute_log_likelihood()
    assert v1 >= v0
    final = tlik_c.restarted_hyperparameter_optimization(optimizer)
    assert final.shape == (3,) and t.compute_log_likelihood() >= v1 - 1e-9


# ---------------------------------------------------------------------------
# expected improvement and the estimation policies
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["analytic", "monte_carlo",
                                  "q2_being_sampled"])
def test_expected_improvement_matches_jax(gps, case):
    j_gp, t_gp = gps["value"]
    kw = dict(num_mc_iterations=M)
    pts = PTS[:1]
    if case == "q2_being_sampled":
        pts = PTS[:2]
        kw["points_being_sampled"] = PTS[2:]
    j = jei_c.ExpectedImprovement(j_gp, points_to_sample=pts, **kw)
    t = tei_c.ExpectedImprovement(t_gp, points_to_sample=pts, **kw)
    convert.carry_normals(t, np.asarray(j._normals))
    force = case == "monte_carlo"
    if force:
        v_j = j.compute_expected_improvement(force_monte_carlo=True)
        g_j = j.compute_grad_expected_improvement(force_monte_carlo=True)
    else:
        v_j, g_j = jax.jit(j.value_and_grad_jax)(jax.numpy.asarray(pts))
    _close(t.compute_expected_improvement(force_monte_carlo=force), v_j,
           VAL)
    _close(t.compute_grad_expected_improvement(force_monte_carlo=force), g_j,
           VAL)
    if case == "analytic":
        cand = np.linspace(-1, 1, 5)[:, None].repeat(2, axis=1)
        _close(t.evaluate_at_point_list(cand), j.evaluate_at_point_list(cand),
               VAL)


@pytest.mark.parametrize("case", ["value_and_grad", "point_list"])
def test_expected_improvement_mcmc_matches_jax(ensemble, case):
    j_m, t_m = ensemble
    j = jeim_c.ExpectedImprovementMCMC(j_m, num_to_sample=1,
                                       num_mc_iterations=M)
    t = teim_c.ExpectedImprovementMCMC(t_m, num_to_sample=1,
                                       num_mc_iterations=M)
    convert.carry_normals(t, np.asarray(j._normals))
    if case == "value_and_grad":
        t.set_current_point(PTS[:1])
        v_j, g_j = jax.jit(j.value_and_grad_jax)(jax.numpy.asarray(PTS[:1]))
        _close(t.compute_expected_improvement_mcmc(), v_j, VAL)
        _close(t.compute_grad_expected_improvement_mcmc(), g_j, VAL)
    else:
        vals = t.evaluate_at_point_list(PTS)
        _close(vals, j.evaluate_at_point_list(PTS), VAL)
        for i, p in enumerate(PTS):
            t.set_current_point(p[None])
            np.testing.assert_allclose(
                vals[i], t.compute_expected_improvement_mcmc(), rtol=1e-10)


@pytest.mark.parametrize("policy", ["constant_liar_min", "constant_liar_max",
                                    "constant_liar_mean", "kriging_0",
                                    "kriging_1"])
def test_estimation_policies_match_jax(gps, policy):
    j_gp, t_gp = gps["value"]
    values = j_gp._points_sampled_value[:, 0]
    if policy.startswith("constant"):
        j = jpol.ConstantLiarEstimationPolicy.from_method(policy, values)
        t = tpol.ConstantLiarEstimationPolicy.from_method(policy, values)
    else:
        coef = float(policy[-1])
        j = jpol.KrigingBelieverEstimationPolicy(std_deviation_coef=coef)
        t = tpol.KrigingBelieverEstimationPolicy(std_deviation_coef=coef)
    got, ref = t.compute_estimate(t_gp, PTS[0]), \
        j.compute_estimate(j_gp, PTS[0])
    assert got[1] == ref[1]
    if policy.startswith("constant"):
        assert float(got[0]) == float(ref[0])
    else:
        # mu + c sigma: a posterior through two BLAS libraries
        _close(float(got[0]), float(ref[0]), dict(rtol=1e-12, atol=0))


# ---------------------------------------------------------------------------
# posterior mean and knowledge gradient
# ---------------------------------------------------------------------------

def test_posterior_mean_matches_jax(gps, ensemble):
    """PosteriorMean and PosteriorMeanMCMC values and gradients, the
    compat posterior_mean_optimization and the Newton optimizer."""
    j_gp, t_gp = gps["value"]
    j_m, t_m = ensemble
    for j, t in ((jkg_c.PosteriorMean(j_gp), tkg_c.PosteriorMean(t_gp)),
                 (jkgm_c.PosteriorMeanMCMC(j_m),
                  tkgm_c.PosteriorMeanMCMC(t_m))):
        t.set_current_point(PTS[0])
        v_j, g_j = jax.jit(j.value_and_grad_jax)(jax.numpy.asarray(PTS[0]))
        _close(t.compute_objective_function(), v_j, VAL)
        _close(t.compute_grad_objective_function(), g_j, VAL)
    jd, td = _doms()
    guesses = np.linspace(-1, 1, 6)[:, None].repeat(2, axis=1) * [1, -0.5]
    params = dict(INNER, max_num_steps=15)
    j, t = jkg_c.PosteriorMean(j_gp), tkg_c.PosteriorMean(t_gp)
    _close(tkg_c.posterior_mean_optimization(
        topt_c.GradientDescentOptimizer(
            td, t, topt_c.GradientDescentParameters(**params)),
        initial_guess=guesses),
        jkg_c.posterior_mean_optimization(
            jopt_c.GradientDescentOptimizer(
                jd, j, jopt_c.GradientDescentParameters(**params)),
            initial_guess=guesses), ENDS)
    newton = dict(max_num_steps=5, gamma=1.05, time_factor=1e-2,
                  max_relative_change=0.5)
    for obj in (j, t):
        obj.set_current_point(PTS[1])
    _close(topt_c.NewtonOptimizer(
        td, t, topt_c.NewtonParameters(**newton)).optimize(),
        jopt_c.NewtonOptimizer(
            jd, j, jopt_c.NewtonParameters(**newton)).optimize(), ENDS)


@pytest.mark.parametrize("being", [False, True], ids=["q", "q_plus_p"])
def test_knowledge_gradient_matches_jax(gps, being):
    """One GP's KG value and gradient on the same normals and
    discretization, and its point list."""
    j_gp, t_gp = gps["value"]
    discrete = np.random.default_rng(5).random((5, 2)) * 2 - 1
    kw = dict(points_to_sample=PTS[:2], num_mc_iterations=M,
              points_being_sampled=PTS[2:] if being else None)
    j = jkg_c.KnowledgeGradient(
        j_gp, jopt_c.GradientDescentParameters(**INNER), discrete, **kw)
    t = tkg_c.KnowledgeGradient(
        t_gp, topt_c.GradientDescentParameters(**INNER), discrete, **kw)
    convert.carry_normals(t, np.asarray(j._normals))
    assert t._best_so_far == pytest.approx(j._best_so_far, rel=1e-12)
    vg = jax.jit(j.value_and_grad_jax)
    v_j, g_j = vg(jax.numpy.asarray(PTS[:2]))
    _close(t.compute_knowledge_gradient(), v_j, KG)
    _close(t.compute_grad_knowledge_gradient(), g_j, KG)
    if not being:
        blocks = np.stack([PTS[:2], PTS[1:]])
        _close(t.evaluate_at_point_list(blocks),
               [vg(jax.numpy.asarray(b))[0] for b in blocks], KG)


@pytest.mark.parametrize("case", ["q", "q_plus_p", "point_list"])
def test_knowledge_gradient_mcmc_matches_jax(ensemble, case):
    """The ensemble KG value and gradient on the same normals and per-member
    discretizations (with a point being sampled: the union of q + p), and
    its point list against point-by-point evaluation and the JAX
    package's."""
    j_m, t_m = ensemble
    discrete = list(np.random.default_rng(6).random((S, 4, 2)) * 2 - 1)
    q = 1 if case == "point_list" else 2
    kw = dict(num_fidelity=0, discrete_pts_list=discrete, num_to_sample=q,
              num_mc_iterations=8,
              points_being_sampled=PTS[2:] if case == "q_plus_p" else None)
    j = jkgm_c.KnowledgeGradientMCMC(
        j_m, inner_optimizer=jopt_c.GradientDescentParameters(**INNER), **kw)
    t = tkgm_c.KnowledgeGradientMCMC(
        t_m, inner_optimizer=topt_c.GradientDescentParameters(**INNER), **kw)
    convert.carry_normals(t, np.asarray(j._normals))
    _close(t._best_so_far_list, j._best_so_far_list, VAL)
    vg = jax.jit(j.value_and_grad_jax)
    if case == "point_list":
        vals = t.evaluate_at_point_list(PTS[:2])
        _close(vals, [vg(jax.numpy.asarray(p[None]))[0] for p in PTS[:2]],
               KG)
        for i, p in enumerate(PTS[:2]):
            t.set_current_point(p[None])
            np.testing.assert_allclose(
                vals[i], t.compute_knowledge_gradient_mcmc(), rtol=1e-10)
        return
    t.set_current_point(PTS[:2])
    v_j, g_j = vg(jax.numpy.asarray(PTS[:2]))
    _close(t.compute_knowledge_gradient_mcmc(), v_j, KG)
    _close(t.compute_grad_knowledge_gradient_mcmc(), g_j, KG)


# ---------------------------------------------------------------------------
# the entry points that draw for themselves
# ---------------------------------------------------------------------------

def _inside(points, bounds=BOX):
    b = np.asarray(bounds)
    return bool(np.all((points >= b[:, 0]) & (points <= b[:, 1])))


@pytest.mark.parametrize("entry", ["ei", "ei_mcmc", "kg", "kg_mcmc",
                                   "kg_mcmc_being", "heuristic_ei"])
def test_multistart_entry_points(gps, ensemble, entry):
    """Each compat multistart: q points inside the domain, a finite
    objective there, and its status flag."""
    _, t_gp = gps["value"]
    _, t_m = ensemble
    _, td = _doms()
    params = topt_c.GradientDescentParameters(**OUTER)
    inner = topt_c.GradientDescentParameters(**INNER)
    discrete = np.random.default_rng(7).random((4, 2)) * 2 - 1
    status = {}
    q = 1 if entry in ("ei", "kg") else 2
    if entry in ("ei", "heuristic_ei"):
        obj = tei_c.ExpectedImprovement(t_gp, num_mc_iterations=M)
    elif entry == "ei_mcmc":
        obj = teim_c.ExpectedImprovementMCMC(t_m, num_to_sample=q,
                                             num_mc_iterations=M)
    elif entry == "kg":
        obj = tkg_c.KnowledgeGradient(t_gp, inner, discrete,
                                      num_mc_iterations=8)
    else:
        obj = tkgm_c.KnowledgeGradientMCMC(
            t_m, inner_optimizer=inner, discrete_pts_list=[discrete] * S,
            num_to_sample=q, num_mc_iterations=8,
            points_being_sampled=PTS[2:] if entry.endswith("being") else None)
    optimizer = topt_c.GradientDescentOptimizer(td, obj, params)
    if entry == "heuristic_ei":
        best = tei_c.heuristic_expected_improvement_optimization(
            optimizer, 3, estimation_policy=tpol.ConstantLiarEstimationPolicy(
                lie_value=-1.0), status=status)
        assert best.shape == (3, 2) and _inside(best)
        assert status["heuristic_ei_found_update"]
        return
    run = {"ei": tei_c.multistart_expected_improvement_optimization,
           "ei_mcmc": teim_c.multistart_expected_improvement_mcmc_optimization,
           "kg": tkg_c.multistart_knowledge_gradient_optimization}.get(
        entry, tkgm_c.multistart_knowledge_gradient_mcmc_optimization)
    best = run(optimizer, status=status,
               generator=torch.Generator().manual_seed(1))
    assert best.shape == (q, 2) and _inside(best)
    assert status["gradient_descent_found_update"]
    obj.set_current_point(best)
    assert np.isfinite(obj.compute_objective_function())


@pytest.mark.parametrize("optimizer", ["gradient_descent", "null", "lbfgsb",
                                       "cobyla"])
def test_optimizers_polish_from_the_current_point(gps, optimizer):
    """optimize() from the objective's current point: no worse than the
    start (gradient ascent with a small step; the scipy optimizers on
    float64 numpy), the point left on the objective; multistart_optimize
    returns its starts' optima, best first."""
    _, t_gp = gps["value"]
    obj = tkg_c.PosteriorMean(t_gp)
    obj.set_current_point(PTS[0])
    v0 = obj.compute_objective_function()
    _, td = _doms()
    cls, params = {
        "gradient_descent": (topt_c.GradientDescentOptimizer,
                             topt_c.GradientDescentParameters(
                                 **dict(INNER, max_num_steps=10,
                                        pre_mult=0.05, gamma=0.7))),
        "null": (topt_c.NullOptimizer, topt_c.NullParameters()),
        "lbfgsb": (topt_c.LBFGSBOptimizer, topt_c.LBFGSBParameters(
            True, 50, 10, 1e7, 1e-5, 1e-8)),
        "cobyla": (topt_c.COBYLAOptimizer, topt_c.COBYLAParameters(
            0.1, 1e-4, 100, 1e-6))}[optimizer]
    opt = cls(td, obj, params)
    x = opt.optimize()
    np.testing.assert_array_equal(obj.get_current_point(), x)
    assert obj.compute_objective_function() >= v0 - 1e-12
    if optimizer == "null":
        np.testing.assert_array_equal(x, PTS[0])
    if optimizer in ("lbfgsb", "gradient_descent"):
        results = topt_c.multistart_optimize(opt, num_multistarts=3)
        values = []
        for p in results:
            obj.set_current_point(p)
            values.append(obj.compute_objective_function())
        assert results.shape == (3, 2) and values == sorted(values)[::-1]


# ---------------------------------------------------------------------------
# misc, constant, geometry, rng
# ---------------------------------------------------------------------------

def test_misc_utilities(caplog):
    a = np.arange(6.0).reshape(2, 3)
    flat = tmisc.cppify(a)
    assert flat.shape == (6,)
    np.testing.assert_array_equal(tmisc.uncppify(flat, (2, 3)), a)
    np.testing.assert_array_equal(tmisc.cppify_hyperparameters([1, 2]),
                                  [1.0, 2.0])
    assert tmisc.COVARIANCE_TYPES_TO_CLASSES[
        tconst.SQUARE_EXPONENTIAL_COVARIANCE_TYPE].python_covariance_class \
        is tcov_c.SquareExponential
    assert tmisc.DOMAIN_TYPES_TO_CLASSES[
        tconst.TENSOR_PRODUCT_DOMAIN_TYPE].python_domain_class is \
        tdom_c.TensorProductDomain
    assert tmisc.LOG_LIKELIHOOD_TYPES_TO_CLASSES[
        tconst.LEAVE_ONE_OUT_LOG_LIKELIHOOD].log_likelihood_class is \
        tlik_c.GaussianProcessLeaveOneOutLogLikelihood
    assert tllm_c.GaussianProcessLogLikelihoodMCMC is \
        tmcmc.GaussianProcessLogLikelihoodMCMC

    class Thing(tmisc.EqualityComparisonMixin):
        def __init__(self, v):
            self.v = v

    assert Thing(1) == Thing(1) and Thing(1) != Thing(2)
    assert Thing(np.ones(2)) == Thing(np.ones(2))
    assert Thing(torch.ones(2)) == Thing(torch.ones(2))
    assert Thing(torch.ones(2)) != Thing(torch.zeros(2))
    with caplog.at_level(logging.INFO):
        with tmisc.timing_context("block"):
            pass
    assert "block took" in caplog.text


def test_constants_match_jax():
    from cornell_moe_tpu.utils import constant as jconst
    for name in dir(jconst):
        if name.isupper():
            j, t = getattr(jconst, name), getattr(tconst, name)
            if hasattr(j, "__dataclass_fields__"):
                assert type(t) is getattr(topt, type(j).__name__)
                assert vars(t) == vars(j), name
            else:
                assert t == j, name


def test_geometry_matches_jax():
    iv = tgeo.ClosedInterval(0.0, 2.0)
    assert iv.length == 2.0 and iv.is_inside(1.0) and not iv.is_inside(3.0)
    assert not iv.is_empty()
    bounds = [(0, 1), (5, 6)]
    np.testing.assert_array_equal(
        tgeo.generate_latin_hypercube_points(10, bounds, seed=0),
        jgeo.generate_latin_hypercube_points(10, bounds, seed=0))
    np.testing.assert_array_equal(
        tgeo.generate_grid_points([3, 4], [(0, 1), (0, 1)]),
        jgeo.generate_grid_points([3, 4], [(0, 1), (0, 1)]))
    for p in ([0.5, 5.5], [1.5, 5.5], [0.2, 0.3], [0.7, 0.6]):
        assert tgeo.check_point_inside_hypercube(bounds, p) == \
            jgeo.check_point_inside_hypercube(bounds, p)
        assert tgeo.check_point_in_unit_simplex(p) == \
            jgeo.check_point_in_unit_simplex(p)
    normal = np.array([0.6, 0.8])
    for kw in (dict(offset=-0.5), dict(point=[1.0, 1.0]), {}):
        tp, jp = tgeo.Plane(normal, **kw), jgeo.Plane(normal, **kw)
        assert tp.dim == 2 and tp.offset == jp.offset
        x, v = np.array([0.3, -0.2]), np.array([1.0, 2.0])
        assert tp.orthogonal_distance_to_point(x) == \
            jp.orthogonal_distance_to_point(x)
        np.testing.assert_array_equal(tp.orthogonal_projection_onto_plane(x),
                                      jp.orthogonal_projection_onto_plane(x))
        assert tp.distance_to_plane_along_vector(x, v) == \
            jp.distance_to_plane_along_vector(x, v)


@pytest.mark.parametrize("source", ["uniform", "normal"])
def test_randomness_source_container(source):
    """The reference's contract: reset gives the same draws again, a new
    explicit seed other draws, one stream per normal thread (distinct
    streams), and a randomized seed other draws than the explicit one."""
    rsc = RandomnessSourceContainer(num_normal_rng_streams=4, seed=7, **CPU)
    assert rsc.device == torch.device("cpu") and len(
        rsc.normal_generators) == 4
    if source == "uniform":
        def draw():
            return rsc.uniform((5,))
        reset, explicit, randomized = (
            rsc.reset_uniform_generator_seed,
            rsc.set_explicit_uniform_generator_seed,
            rsc.set_randomized_uniform_generator_seed)
    else:
        def draw():
            return rsc.normals((5,))
        reset, explicit, randomized = (
            rsc.reset_normal_rng_seed, rsc.set_explicit_normal_rng_seed,
            rsc.set_randomized_normal_rng_seed)
    first, second = draw(), draw()
    assert not torch.equal(first, second)
    reset()
    assert torch.equal(draw(), first)
    if source == "uniform":
        assert bool(((first >= 0) & (first < 1)).all())
        g = rsc.uniform_generator
        rsc.reset_uniform_generator_seed()
        dom = tdom_c.TensorProductDomain(BOX, **CPU)
        a = dom.generate_uniform_random_points_in_domain(3, rsc)
        rsc.reset_uniform_generator_seed()
        assert rsc.uniform_generator is g and np.array_equal(
            a, dom.generate_uniform_random_points_in_domain(3, rsc))
    else:
        assert first.shape == (4, 5)
        assert len({tuple(r.tolist()) for r in first}) == 4
        rsc.reset_normal_rng_seed()
        stream = rsc.normal((5,), stream=2)
        rsc.reset_normal_rng_seed()
        assert torch.equal(rsc.normals((5,))[2], stream)
    explicit(8)
    assert not torch.equal(draw(), first)
    explicit(7)
    assert torch.equal(draw(), first)
    randomized(7)
    assert not torch.equal(draw(), first)


def test_entry_points_need_a_card_unless_told_the_cpu(monkeypatch):
    """Without a card, a compat object given no device raises, as every
    entry point of the port does (config.default_device)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: tcov_c.MaternNu2p5(HYPERS),
                 lambda: tdom_c.TensorProductDomain(BOX),
                 lambda: RandomnessSourceContainer(),
                 lambda: tkgm_c.GaussianProcessMCMC(
                     [HYPERS], [[1e-3]], _data(TData))):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            make()
