"""Parity of the port's continuous-fidelity KG (cf-KG) and LCB paths with the
JAX package, in float64.

Tolerances: the fidelity cost and pinning exactly
(tests/test_knowledge_gradient.py:157); fantasy mean, descent direction,
descent endpoints and KG values at rtol 1e-9 / atol 1e-11, union gradients
(fidelity columns included) at rtol 1e-7 / atol 1e-9
(tests/test_knowledge_gradient.py:50, as tests/test_torch_dkg.py holds
d-KG); the posterior-mean optimum at rtol 1e-9 / atol 1e-11; the whole
cf-KG slice at rtol 1e-7 / atol 1e-9 (as tests/test_torch_driver.py holds
the q-KG slice); the grown factor, K^-1 y and L^-1 of
``add_sampled_points`` at rtol 1e-9 / atol 1e-10 and the LCB picks at
rtol 1e-12 (tests/test_gp.py:31, tests/test_driver_extras.py:136); the
objective at rtol 1e-12.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cornell_moe_tpu import bayes_opt as jbo
from cornell_moe_tpu.acquisition import knowledge_gradient as jkg
from cornell_moe_tpu.acquisition.lower_confidence_bound import (
    lower_confidence_bound_optimization as jlcb)
from cornell_moe_tpu.models import covariance as jcov
from cornell_moe_tpu.models import gp as jgp
from cornell_moe_tpu.models import mcmc as jmcmc
from cornell_moe_tpu.ops import linalg as jlinalg
from cornell_moe_tpu.ops import optimizers as jopt
from cornell_moe_tpu.ops.domains import RepeatedDomain as JRep
from cornell_moe_tpu.ops.domains import TensorProductDomain as JDom
from cornell_moe_tpu.utils import synthetic_functions as jsf
from cornell_moe_tpu_torch import bayes_opt as tbo
from cornell_moe_tpu_torch.acquisition import knowledge_gradient as tkg
from cornell_moe_tpu_torch.acquisition.lower_confidence_bound import (
    lower_confidence_bound_optimization as tlcb, posterior_stddev)
from cornell_moe_tpu_torch.models import covariance as tcov
from cornell_moe_tpu_torch.models import gp as tgp
from cornell_moe_tpu_torch.models import mcmc as tmcmc
from cornell_moe_tpu_torch.ops import linalg as tlinalg
from cornell_moe_tpu_torch.ops import optimizers as topt
from cornell_moe_tpu_torch.ops.domains import RepeatedDomain as TRep
from cornell_moe_tpu_torch.ops.domains import TensorProductDomain as TDom
from cornell_moe_tpu_torch.utils import synthetic_functions as tsf

torch.set_num_threads(1)
F64 = torch.float64
TOL = dict(rtol=1e-9, atol=1e-11)
GRAD = dict(rtol=1e-7, atol=1e-9)
SLICE = dict(rtol=1e-7, atol=1e-9)
MEAN_TOL = dict(rtol=1e-9, atol=1e-10)
S, B, Q, M, NF = 2, 3, 2, 16, 1
BOX = [[0.0, 1.0], [0.05, 1.0]]          # the last coordinate is fidelity
INNER = dict(num_multistarts=1, max_num_steps=6, max_num_restarts=1,
             num_steps_averaged=3, gamma=0.0, pre_mult=1.0,
             max_relative_change=0.1)
INNER_WARM = dict(INNER, max_num_steps=1, num_steps_averaged=0)


def _t(a, dtype=F64):
    return torch.as_tensor(np.array(a), dtype=dtype)


def _doms(box=BOX):
    return JDom.from_bounds(box), TDom.from_bounds(box)


# ---------------------------------------------------------------------------
# cost and pinning
# ---------------------------------------------------------------------------

def test_fidelity_cost_and_pinning():
    """Port twin of tests/test_knowledge_gradient.py:157 (the arguments
    by the JAX package's names), and the port's batched cost over a stack
    of unions equal to JAX's per union."""
    union = np.array([[0.5, 0.2, 0.8], [0.1, 0.9, 0.5]])
    for nf, want in ((1, 0.8), (2, max(0.2 * 0.8, 0.9 * 0.5)), (0, 1.0)):
        got = tkg.fidelity_cost(union=_t(union), num_to_sample=2,
                                num_fidelity=nf)
        assert float(got) == want == float(jkg.fidelity_cost(
            union=jnp.asarray(union), num_to_sample=2, num_fidelity=nf))
    stack = np.random.default_rng(3).random((4, 3, 3))
    got = tkg.fidelity_cost(_t(stack), 2, 1)
    assert got.shape == (4,)
    np.testing.assert_array_equal(
        got.numpy(), [float(jkg.fidelity_cost(jnp.asarray(u), 2, 1))
                      for u in stack])
    np.testing.assert_array_equal(
        tkg._pin_fidelity(_t([[0.3], [0.6]]), 2).numpy(),
        [[0.3, 1.0, 1.0], [0.6, 1.0, 1.0]])
    np.testing.assert_array_equal(
        np.asarray(jkg._pin_fidelity(jnp.asarray([0.3]), 3, 2)),
        tkg._pin_fidelity(_t([0.3]), 2).numpy())


@pytest.mark.parametrize("num_fidelity", [1, 2])
def test_fidelity_cost_value_and_gradient_match_jax(num_fidelity):
    """The cost and its gradient with respect to the unions, against
    ``jax.grad`` of the JAX package's ``jnp.max(jnp.prod(...))``, float64,
    to 1e-12: unions of q = 3 points to sample and one being sampled, with
    a fidelity coordinate exactly 0 off the max (union 0) and at the max
    (union 1, whose other points' products are negative), where the
    product's gradient is the product of the other columns."""
    q, d = 3, 4
    rng = np.random.default_rng(11)
    unions = rng.uniform(0.05, 1.0, (5, q + 1, d))
    first = d - num_fidelity
    unions[0, 1, first] = 0.0
    unions[1, 0, first] = 0.0
    unions[1, 1:q, d - 1] = -rng.uniform(0.1, 1.0, q - 1)
    with torch.enable_grad():
        u = _t(unions).requires_grad_(True)
        cost = tkg.fidelity_cost(u, q, num_fidelity)
        (grad,) = torch.autograd.grad(cost.sum(), u)
    cost = cost.detach()
    assert float(cost[1]) == 0.0

    def jcost(x):
        return jkg.fidelity_cost(x, q, num_fidelity)

    want = np.array([float(jcost(jnp.asarray(x))) for x in unions])
    want_grad = np.stack([np.asarray(jax.grad(jcost)(jnp.asarray(x)))
                          for x in unions])
    np.testing.assert_allclose(cost.numpy(), want, rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(grad.numpy(), want_grad, rtol=1e-12,
                               atol=1e-12)
    assert grad[1, 0, first] != 0.0


@pytest.mark.parametrize("case, expected", [
    (dict(), "matern_2.5"), (dict(num_fidelity=1), None),
    (dict(num_fidelity=2, d=3), None)])
def test_descent_gate_sends_fidelity_dims_to_the_plain_route(case,
                                                             expected):
    """Kernel A's gate takes no fidelity dim, as the JAX package's fast path
    requires num_fidelity == 0 (knowledge_gradient.py:771)."""
    args = dict(device_type="cuda", dtype=torch.float32,
                kernel_name="matern_2.5", derivatives=(),
                derivatives_to_sample=(), d=2, q=4)
    args.update(case)
    assert tkg.descent_kernel_for(**args) == expected


# ---------------------------------------------------------------------------
# a fidelity state (tests/test_kg_warm_start.py:341's problem)
# ---------------------------------------------------------------------------

@pytest.fixture
def problem(rng):
    x = rng.uniform(0.0, 1.0, (10, 2))
    x[:, 1] = 0.05 + 0.95 * x[:, 1]
    y = (np.sin(3 * x[:, 0]) * (0.5 + 0.5 * x[:, 1]))[:, None]
    hypers = np.abs(rng.standard_normal((S, 3))) + 0.8
    noises = np.full((S, 1), 1e-3)
    unions = rng.random((B, Q, 2))
    unions[..., 1] = 0.05 + 0.95 * unions[..., 1]
    return dict(
        x=x, y=y,
        j=jmcmc.fit_gp_ensemble("matern_2.5", jnp.asarray(hypers),
                                jnp.asarray(noises), x, y),
        t=tmcmc.fit_gp_ensemble("matern_2.5", _t(hypers), _t(noises), x, y),
        unions=unions, normals=rng.standard_normal((M, Q)),
        discrete=rng.uniform(0.0, 1.0, (S, 7, 1)),
        best=np.array([y.min(), y.min() + 0.05]))


def test_posterior_mean_optimum_with_fidelity_matches_jax(problem, rng):
    """The pinned objective, best-so-far over a discretization and the
    GD-polished posterior-mean optimum over the inner domain."""
    jdom, tdom = _doms(BOX[:1])
    guesses = rng.uniform(0.0, 1.0, (S, 12, 1))
    params = dict(tbo.DEFAULT_SGD_PARAMS_PS.__dict__)
    pt, val = tkg.compute_optimal_posterior_mean(
        problem["t"], tdom, _t(guesses), topt.GradientDescentParameters(
            **params), NF)
    np.testing.assert_allclose(
        tbo.best_so_far_from_discretization(problem["t"], _t(
            problem["discrete"]), NF).numpy(),
        np.asarray(jbo.best_so_far_from_discretization(
            problem["j"], jnp.asarray(problem["discrete"]), NF)), **MEAN_TOL)
    optimum = jax.jit(lambda st, g: jkg.compute_optimal_posterior_mean(
        st, jdom, g, jopt.GradientDescentParameters(**params), NF))
    for i in range(S):
        member = jmcmc.ensemble_member(problem["j"], i)
        ref_pt, ref_val = optimum(member, jnp.asarray(guesses[i]))
        np.testing.assert_allclose(pt[i].numpy(), np.asarray(ref_pt), **TOL)
        np.testing.assert_allclose(float(val[i]), float(ref_val), **TOL)
        np.testing.assert_allclose(
            float(tkg.posterior_mean_objective(problem["t"].member(i),
                                               _t(guesses[i, 0]), NF)),
            float(jkg.posterior_mean_objective(
                member, jnp.asarray(guesses[i, 0]), NF)), **MEAN_TOL)


def test_fantasy_mean_with_fidelity_and_its_direction_match_jax(problem,
                                                                rng):
    """The frozen fantasy mean at x (S, B, M, dim_opt) with the fidelity
    coordinate pinned, and the autograd direction of the inner descent,
    against JAX's jax.grad of the summed mean."""
    v = 0.1 * rng.standard_normal((S, B, 10, Q))
    betas = rng.standard_normal((S, B, M, Q))
    x = rng.random((S, B, M, 1))
    unions, normals = problem["unions"], problem["normals"]
    mu_t = tkg._fantasy_mean_batch(problem["t"], _t(x), _t(unions), _t(v),
                                   _t(betas), _t(normals), (), NF)
    _, g_t = tkg._make_fantasy_mean_grad_fn(problem["t"], _t(unions), _t(v),
                                            _t(betas), _t(normals), (),
                                            NF)(_t(x))
    assert g_t.shape == (S, B, M, 1)

    def neg_sum(xx, member, vi, betas_i):
        return -jnp.sum(jkg._fantasy_mean_batch(
            member, xx, jnp.asarray(unions), vi, betas_i,
            jnp.asarray(normals), (), NF))

    value_and_grad = jax.jit(jax.value_and_grad(neg_sum))
    for i in range(S):
        val, grad = value_and_grad(
            jnp.asarray(x[i]), jmcmc.ensemble_member(problem["j"], i),
            jnp.asarray(v[i]), jnp.asarray(betas[i]))
        np.testing.assert_allclose(float(mu_t[i].sum()), -float(val), **TOL)
        np.testing.assert_allclose(g_t[i].numpy(), np.asarray(grad), **TOL)


def _jax_batch(problem, params, inner_x0=None):
    jdom, _ = _doms(BOX[:1])

    def f(u):
        return jkg.knowledge_gradient_mcmc_batch(
            problem["j"], u, jnp.asarray(problem["discrete"]),
            jnp.asarray(problem["normals"]), jdom, params,
            jnp.asarray(problem["best"]), Q, num_fidelity=NF,
            inner_x0=inner_x0, return_x_star=True)

    (vals, xs), vjp = jax.vjp(jax.jit(f), jnp.asarray(problem["unions"]))
    (grads,) = vjp((jnp.ones_like(vals), jnp.zeros_like(xs)))
    return vals, grads, xs


@pytest.mark.parametrize("mode", ["cold", "warm"])
def test_cfkg_batch_matches_jax(problem, mode):
    """Values (divided by the fidelity cost), union gradients with their
    fidelity columns and carried endpoints (S, B, M, dim_opt) of the
    ensemble cf-KG batch, cold and in "reseed" warm mode (the same carry
    given to both)."""
    _, tdom = _doms(BOX[:1])
    params = topt.GradientDescentParameters(**INNER)
    args = (problem["t"], _t(problem["unions"]), _t(problem["discrete"]),
            _t(problem["normals"]), tdom)
    carry = None
    if mode == "warm":
        _, _, carry = tkg.knowledge_gradient_mcmc_batch_vg_carry(
            *args, params, _t(problem["best"]), num_fidelity=NF)
        params = dataclasses.replace(params, max_num_steps=1,
                                     num_steps_averaged=0)
    v_j, g_j, x_j = _jax_batch(
        problem, jopt.GradientDescentParameters(**dataclasses.asdict(params)),
        inner_x0=None if carry is None else jnp.asarray(carry.numpy()))
    v_t, g_t, x_t = tkg.knowledge_gradient_mcmc_batch_vg_carry(
        *args, params, _t(problem["best"]), inner_x0=carry, num_fidelity=NF)
    assert x_t.shape == (S, B, M, 1) and g_t.shape == (B, Q, 2)
    assert torch.all(g_t[..., 1] != 0.0)
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j), **TOL)
    np.testing.assert_allclose(x_t.numpy(), np.asarray(x_j), **TOL)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), **GRAD)


def test_per_union_cfkg_matches_jax(problem):
    """The per-union estimator (the VOI's), divided by the union's cost, and
    its gradient."""
    jdom, tdom = _doms(BOX[:1])

    def kg(u):
        return jkg.knowledge_gradient_mcmc(
            problem["j"], u, jnp.asarray(problem["discrete"]),
            jnp.asarray(problem["normals"]), jdom,
            jopt.GradientDescentParameters(**INNER),
            jnp.asarray(problem["best"]), Q, NF)

    ref, ref_g = jax.jit(jax.value_and_grad(kg))(
        jnp.asarray(problem["unions"][0]))
    u = _t(problem["unions"][0]).requires_grad_(True)
    got = tkg.knowledge_gradient_mcmc(
        problem["t"], u, _t(problem["discrete"]), _t(problem["normals"]),
        tdom, topt.GradientDescentParameters(**INNER), _t(problem["best"]),
        num_fidelity=NF)
    (g,) = torch.autograd.grad(got, u)
    np.testing.assert_allclose(float(got.detach()), float(ref), **TOL)
    np.testing.assert_allclose(g.numpy(), np.asarray(ref_g), **GRAD)


# ---------------------------------------------------------------------------
# the cf-KG slice and the driver
# ---------------------------------------------------------------------------

NSTART = 4
OUTER = dict(num_multistarts=NSTART, max_num_steps=6, max_num_restarts=1,
             num_steps_averaged=3, gamma=0.7, pre_mult=0.4,
             max_relative_change=0.5)
RECOMMEND = dict(num_multistarts=1, max_num_steps=60, max_num_restarts=1,
                 num_steps_averaged=15, gamma=0.7, pre_mult=1.0,
                 max_relative_change=0.02)


@pytest.fixture
def slice_problem(problem, rng):
    starts = rng.random((NSTART, Q, 2))
    starts[..., 1] = 0.05 + 0.95 * starts[..., 1]
    return dict(problem, starts=starts,
                normals_voi=rng.standard_normal((M, Q)),
                grid=rng.random((80, 1)))


def _jax_slice(p):
    j = p["j"]
    dom, inner = _doms()[0], _doms(BOX[:1])[0]
    rep = JRep(domain=dom, num_repeats=Q)
    disc, normals = jnp.asarray(p["discrete"]), jnp.asarray(p["normals"])
    best = jbo.best_so_far_from_discretization(j, disc, NF)
    cold = jopt.GradientDescentParameters(**INNER)
    warm = jopt.GradientDescentParameters(**INNER_WARM)

    def suggest(starts):
        def bvg_cold(u):
            return jkg.knowledge_gradient_mcmc_batch_vg_carry(
                j, u, disc, normals, inner, cold, best, Q, NF)

        def bvg_warm(u, carry):
            return jkg.knowledge_gradient_mcmc_batch_vg_carry(
                j, u, disc, normals, inner, warm, best, Q, NF,
                inner_x0=carry, warm_mode="reseed")

        res = jopt.multistart_optimize_batched_warm(
            bvg_cold, bvg_warm, rep, starts,
            jopt.GradientDescentParameters(**OUTER), chunk_size=2,
            conv_tol=3e-3)
        return res.best_point, res.best_value, res.all_points

    point, value, allp = jax.jit(suggest)(jnp.asarray(p["starts"]))
    voi = jax.jit(lambda u: jkg.knowledge_gradient_mcmc(
        j, u, disc, jnp.asarray(p["normals_voi"]), inner, cold, best, Q,
        NF))(point)

    def neg_mean(x):
        return jnp.mean(jax.vmap(
            lambda s: jkg.posterior_mean_objective(s, x, NF))(j))

    def recommend(guesses):
        vals = jax.vmap(neg_mean)(guesses)
        vals = jnp.where(jnp.isfinite(vals), vals, -jnp.inf)
        x0 = guesses[jnp.argmax(vals)]
        x = jopt.gradient_ascent(jax.value_and_grad(neg_mean), inner, x0,
                                 jopt.GradientDescentParameters(**RECOMMEND))
        return jnp.where(neg_mean(x) > vals.max(), x, x0)

    rec = jax.jit(recommend)(jnp.asarray(p["grid"]))
    return best, point, value, allp, voi, rec


def _torch_slice(p):
    t = p["t"]
    dom, inner = _doms()[1], _doms(BOX[:1])[1]
    rep = TRep(domain=dom, num_repeats=Q)
    disc, normals = _t(p["discrete"]), _t(p["normals"])
    best = tbo.best_so_far_from_discretization(t, disc, NF)
    cold = topt.GradientDescentParameters(**INNER)
    warm = topt.GradientDescentParameters(**INNER_WARM)

    def bvg_cold(u):
        return tkg.knowledge_gradient_mcmc_batch_vg_carry(
            t, u, disc, normals, inner, cold, best, num_fidelity=NF)

    def bvg_warm(u, carry):
        return tkg.knowledge_gradient_mcmc_batch_vg_carry(
            t, u, disc, normals, inner, warm, best, inner_x0=carry,
            num_fidelity=NF)

    res = topt.multistart_optimize_batched_warm(
        bvg_cold, bvg_warm, rep, _t(p["starts"]),
        topt.GradientDescentParameters(**OUTER), chunk_size=2,
        conv_tol=3e-3)
    voi = tkg.knowledge_gradient_mcmc(t, res.best_point, disc,
                                      _t(p["normals_voi"]), inner, cold,
                                      best, num_fidelity=NF)
    rec = tbo.recommend_from_guesses(
        t, inner, _t(p["grid"]), topt.GradientDescentParameters(**RECOMMEND),
        num_fidelity=NF)
    return best, res.best_point, res.best_value, res.all_points, voi, rec


def test_cfkg_slice_matches_jax(slice_problem):
    """The cf-KG slice as a whole (tests/test_dkg_fidelity_e2e.py:61's
    iteration, composed as tests/test_torch_driver.py composes q-KG's):
    S = 2, one fidelity dim, the same starts, normals and discretization;
    best-so-far, the warm gated multistart over all coordinates, the VOI
    divided by the cost, and the recommendation on the inner domain."""
    names = ("best_so_far", "suggested", "kg_at_suggested", "all_endpoints",
             "voi", "recommended")
    for name, ref, got in zip(names, _jax_slice(slice_problem),
                              _torch_slice(slice_problem)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                                   err_msg=name, **SLICE)


def test_cfkg_optimizer_run_on_cpu():
    """Port twin of tests/test_dkg_fidelity_e2e.py:61: one cf-KG iteration
    of the driver on BraninFidelity."""
    fast = topt.GradientDescentParameters(
        num_multistarts=4, max_num_steps=8, max_num_restarts=1,
        num_steps_averaged=2, gamma=0.7, pre_mult=1.0,
        max_relative_change=0.5)
    f = tsf.BraninFidelity()
    assert f._num_fidelity == 1
    bo = tbo.BayesianOptimizer(
        objective_func=f, method="KG", num_to_sample=2, num_mc=8,
        n_hypers=8, chain_length=25, burnin_steps=25, noisy=True,
        standardize=True, chain_gate_tol=None, sgd_params=fast,
        device="cpu", verbose=False)
    h = bo.run(num_iterations=1)[0]
    assert h["suggested"].shape == (2, 3)
    assert np.all(h["suggested"][:, 2] >= 0.05 - 1e-9)
    assert np.all(h["suggested"][:, 2] <= 1.0 + 1e-9)
    assert np.isclose(h["capital"], np.max(h["suggested"][:, 2]))
    assert h["recommended"].shape == (3,) and h["recommended"][2] == 1.0
    assert np.isfinite(h["voi"]) and np.isfinite(h["true_value"])


def test_branin_fidelity_matches_jax(rng):
    tf, jf = tsf.BraninFidelity(), jsf.BraninFidelity()
    assert (tf._dim, tf._num_fidelity) == (jf._dim, jf._num_fidelity)
    np.testing.assert_array_equal(tf._search_domain, jf._search_domain)
    box = tf._search_domain
    for p in box[:, 0] + rng.random((5, 3)) * (box[:, 1] - box[:, 0]):
        np.testing.assert_allclose(tf.evaluate_true(p), jf.evaluate_true(p),
                                   rtol=1e-12, atol=1e-12)


# ---------------------------------------------------------------------------
# add_sampled_points and LCB
# ---------------------------------------------------------------------------

def test_chol_update_append_matches_jax(rng):
    a = rng.standard_normal((7, 7))
    a = a @ a.T + 7 * np.eye(7)
    chol = np.linalg.cholesky(a[:5, :5])
    got = tlinalg.chol_update_append(_t(chol), _t(a[:5, 5:]), _t(a[5:, 5:]))
    ref = jlinalg.chol_update_append(jnp.asarray(chol), jnp.asarray(a[:5, 5:]),
                                     jnp.asarray(a[5:, 5:]))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-12,
                               atol=1e-13)
    np.testing.assert_allclose(got.numpy(), np.linalg.cholesky(a),
                               rtol=1e-12, atol=1e-13)
    stacked = tlinalg.chol_update_append(
        _t(np.stack([chol, 2 * chol])), _t(np.stack([a[:5, 5:]] * 2)),
        _t(np.stack([a[5:, 5:]] * 2)))
    np.testing.assert_allclose(stacked[0].numpy(), got.numpy(), rtol=1e-15)


@pytest.mark.parametrize("update_mean", [True, False])
def test_add_sampled_points_matches_jax(problem, rng, update_mean):
    """An ensemble (with L^-1) and a bucket-padded member (with point
    noise) grown by two points with jitter, against the JAX package member
    by member; the grown ensemble's posterior equals a refit's."""
    new_x = rng.random((2, 2))
    new_y = rng.standard_normal((2, 1))
    grown = tgp.add_sampled_points(problem["t"], _t(new_x), _t(new_y),
                                   jitter=0.25, update_mean=update_mean)
    assert grown.chol_K.shape == (S, 12, 12)
    for i in range(S):
        ref = jgp.add_sampled_points(
            jmcmc.ensemble_member(problem["j"], i), jnp.asarray(new_x),
            jnp.asarray(new_y), jitter=0.25, update_mean=update_mean)
        for name in ("chol_K", "K_inv_y", "inv_chol_K", "mean",
                     "points_sampled", "points_sampled_value"):
            np.testing.assert_allclose(getattr(grown, name)[i].numpy(),
                                       np.asarray(getattr(ref, name)),
                                       err_msg=name, **MEAN_TOL)
    padded = tmcmc.fit_gp_ensemble(
        "matern_2.5", _t([[1.1, 0.4, 0.7]]), _t([[1e-3]]), problem["x"],
        problem["y"], bucket=8)
    jpadded = jmcmc.fit_gp_ensemble(
        "matern_2.5", jnp.asarray([[1.1, 0.4, 0.7]]), jnp.asarray([[1e-3]]),
        problem["x"], problem["y"], bucket=8)
    got = tgp.add_sampled_points(padded.member(0), _t(new_x), _t(new_y),
                                 update_mean=update_mean)
    ref = jgp.add_sampled_points(jmcmc.ensemble_member(jpadded, 0),
                                 jnp.asarray(new_x), jnp.asarray(new_y),
                                 update_mean=update_mean)
    assert got.point_noise.shape == (18, 1)
    for name in ("chol_K", "K_inv_y", "point_noise", "mean"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   err_msg=name, **MEAN_TOL)
    refit = tgp.fit_gp(problem["t"].covariance, problem["t"].noise_variance,
                       _t(np.concatenate([problem["x"], new_x])),
                       _t(np.concatenate([problem["y"], new_y])))
    xt = _t(rng.random((4, 2)))
    if update_mean:
        np.testing.assert_allclose(
            tgp.posterior_mean(tgp.add_sampled_points(
                problem["t"], _t(new_x), _t(new_y)), xt).numpy(),
            tgp.posterior_mean(refit, xt).numpy(), **MEAN_TOL)


def _gp_1d(rng, n=10, noise=1e-3, kernel="square_exponential"):
    """tests/test_driver_extras.py:72's GP in both packages."""
    x = np.sort(rng.random(n) * 4 - 2)[:, None]
    y = np.sin(2 * x[:, 0])
    j = jgp.fit_gp(jcov.make_covariance(kernel, [1.0, 0.6]),
                   jnp.asarray([noise]), jnp.asarray(x),
                   jnp.asarray(y)[:, None])
    t = tgp.fit_gp(tcov.make_covariance(kernel, _t([1.0, 0.6])), _t([noise]),
                   _t(x), _t(y[:, None]))
    return j, t


@pytest.mark.parametrize("kernel", ["square_exponential", "matern_2.5"])
def test_lcb_selection_matches_jax(rng, kernel):
    """Port twin of tests/test_driver_extras.py:124: the same q = 3 picks as
    the JAX package, every pick in the plausible set, and the per-point
    standard deviation equal to JAX's."""
    j, t = _gp_1d(rng, kernel=kernel)
    cand = np.linspace(-2, 2, 41)[:, None]
    ref = jax.jit(lambda st, c: jlcb(st, c, 3)[0])(j, jnp.asarray(cand))
    pts, val = tlcb(t, _t(cand), 3)
    assert pts.shape == (3, 1) and val == jlcb(j, cand[:2], 1)[1] == 0.0
    np.testing.assert_allclose(pts.numpy(), np.asarray(ref), rtol=1e-12)
    mu = tgp.posterior_mean(t, _t(cand))[:, 0]
    sd = posterior_stddev(t, _t(cand))
    sd_ref = np.sqrt(np.asarray(jax.jit(jax.vmap(
        lambda p: jgp.posterior_variance(j, p[None])[0, 0]))(
            jnp.asarray(cand))))
    np.testing.assert_allclose(sd.numpy(), sd_ref, rtol=1e-9, atol=1e-10)
    plausible = cand[((mu - sd) <= torch.min(mu + sd)).numpy()]
    for p in pts.numpy():
        assert np.min(np.abs(plausible[:, 0] - p[0])) < 1e-12


def test_lcb_repeats_a_pick_as_the_reference_does(rng):
    """Where the posterior standard deviation over the plausible set is far
    below the fantasy noise (0.25), conditioning on a pick barely lowers
    it, and the reference's rule picks the same candidate again: both
    packages return one point three times on a standardized 40-point
    problem (a fault of the reference, kept as it is)."""
    x = rng.random((40, 2))
    y = np.sin(3 * x[:, 0]) + (x[:, 1] - 0.4) ** 2
    y = ((y - y.mean()) / y.std())[:, None]
    j, t = (jgp.fit_gp(jcov.make_covariance("matern_2.5", [1.0, 0.3, 0.4]),
                       jnp.asarray([1e-4]), jnp.asarray(x), jnp.asarray(y)),
            tgp.fit_gp(tcov.make_covariance("matern_2.5",
                                            _t([1.0, 0.3, 0.4])),
                       _t([1e-4]), _t(x), _t(y)))
    cand = rng.random((300, 2))
    ref = jax.jit(lambda st, c: jlcb(st, c, 3)[0])(j, jnp.asarray(cand))
    pts, _ = tlcb(t, _t(cand), 3)
    np.testing.assert_allclose(pts.numpy(), np.asarray(ref), rtol=1e-12)
    assert len({tuple(p) for p in pts.tolist()}) == 1


def test_cfkg_batch_value_and_grad_matches_jax(problem):
    """knowledge_gradient_mcmc_batch_value_and_grad, the cold delegate of
    the carry estimator: its values and union gradients equal the carry
    estimator's and the JAX package's delegate on the same inputs."""
    jdom, tdom = _doms(BOX[:1])
    params = topt.GradientDescentParameters(**INNER)
    v_t, g_t = tkg.knowledge_gradient_mcmc_batch_value_and_grad(
        problem["t"], _t(problem["unions"]), _t(problem["discrete"]),
        _t(problem["normals"]), tdom, params, _t(problem["best"]), Q,
        num_fidelity=NF)
    v_c, g_c, _ = tkg.knowledge_gradient_mcmc_batch_vg_carry(
        problem["t"], _t(problem["unions"]), _t(problem["discrete"]),
        _t(problem["normals"]), tdom, params, _t(problem["best"]),
        num_fidelity=NF, num_to_sample=Q)
    assert torch.equal(v_t, v_c) and torch.equal(g_t, g_c)
    v_j, g_j = jkg.knowledge_gradient_mcmc_batch_value_and_grad(
        problem["j"], jnp.asarray(problem["unions"]),
        jnp.asarray(problem["discrete"]), jnp.asarray(problem["normals"]),
        jdom, jopt.GradientDescentParameters(**INNER),
        jnp.asarray(problem["best"]), Q, num_fidelity=NF)
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j), **TOL)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), **GRAD)
