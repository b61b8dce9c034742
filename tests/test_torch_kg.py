"""Parity of the port's q-KG (fantasy model, descent, batched and per-union
estimators, posterior-mean optimization) and of the descent kernel's plain
version with the JAX package.

Tolerances: float64 estimator values and descent endpoints at rtol 1e-9 /
atol 1e-11 and union gradients at rtol 1e-7 / atol 1e-9 (batched ==
per-union identities, tests/test_knowledge_gradient.py:50 at 1e-7); the
descent kernel's plain version in float32 against the Pallas kernel in
interpret mode at atol 5e-5 (tests/test_pallas_descent.py:64-65).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cornell_moe_tpu.acquisition import knowledge_gradient as jkg
from cornell_moe_tpu.models import mcmc as jmcmc
from cornell_moe_tpu.ops import optimizers as jopt
from cornell_moe_tpu.ops.domains import TensorProductDomain as JDom
from cornell_moe_tpu_torch import convert
from cornell_moe_tpu_torch.acquisition import knowledge_gradient as tkg
from cornell_moe_tpu_torch.models import mcmc as tmcmc
from cornell_moe_tpu_torch.ops import optimizers as topt
from cornell_moe_tpu_torch.ops.domains import TensorProductDomain as TDom

torch.set_num_threads(1)
TOL = dict(rtol=1e-9, atol=1e-11)
GRAD = dict(rtol=1e-7, atol=1e-9)
S, B, Q, M, N = 3, 3, 2, 8, 20
INNER = dict(num_multistarts=1, max_num_steps=6, max_num_restarts=1,
             num_steps_averaged=3, gamma=0.0, pre_mult=1.0,
             max_relative_change=0.1)


def _t(a, dtype=torch.float64):
    return torch.as_tensor(np.array(a), dtype=dtype)


@pytest.fixture
def problem(rng):
    x = rng.random((N, 2))
    y = (np.sin(3 * x[:, 0]) + x[:, 1])[:, None]
    hypers = np.concatenate([0.8 + rng.random((S, 1)),
                             0.3 + 0.4 * rng.random((S, 2))], axis=1)
    noises = np.full((S, 1), 1e-2)
    j = jmcmc.fit_gp_ensemble("matern_2.5", jnp.asarray(hypers),
                              jnp.asarray(noises), x, y)
    t = tmcmc.fit_gp_ensemble("matern_2.5", _t(hypers), _t(noises), x, y)
    return dict(j=j, t=t, x=x, y=y, hypers=hypers, noises=noises,
                unions=rng.random((B, Q, 2)),
                normals=rng.standard_normal((M, Q)),
                discrete=rng.random((S, 5, 2)),
                best=np.array([-0.1, 0.0, 0.2]))


def _doms():
    return JDom.from_bounds([[0.0, 1.0]] * 2), \
        TDom.from_bounds([[0.0, 1.0]] * 2)


def test_fantasy_model_batch_matches_jax(problem):
    ref = jax.vmap(lambda s: jkg._build_fantasy_model_batch(
        s, jnp.asarray(problem["unions"]), ()))(problem["j"])
    got = tkg._build_fantasy_model_batch(problem["t"],
                                         _t(problem["unions"]))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL)


def test_descent_grad_fn_matches_jax(problem, rng):
    v = 0.1 * rng.standard_normal((S, B, N, Q))
    betas = rng.standard_normal((S, B, M, Q))
    x = rng.random((S, B, M, 2))
    _, g_t = tkg._make_descent_grad_fn(
        problem["t"], _t(problem["unions"]), _t(v), _t(betas),
        _t(problem["normals"]))(_t(x))
    for i in range(S):
        _, g_j = jkg._make_descent_grad_fn(
            jmcmc.ensemble_member(problem["j"], i),
            jnp.asarray(problem["unions"]), jnp.asarray(v[i]),
            jnp.asarray(betas[i]), jnp.asarray(problem["normals"]))(
                jnp.asarray(x[i]))
        np.testing.assert_allclose(g_t[i].numpy(), np.asarray(g_j), **TOL)


def test_descent_kernel_plain_matches_pallas(problem, rng):
    """kernels.descent_run's plain version (float32, CPU), reached through
    the port's _descent_full, against _pallas_descent_full in interpret
    mode, member by member."""
    f32 = np.float32
    hypers = problem["hypers"][:2].astype(f32)
    noises = problem["noises"][:2].astype(f32)
    x, y = problem["x"].astype(f32), problem["y"].astype(f32)
    j32 = jmcmc.fit_gp_ensemble("matern_2.5", jnp.asarray(hypers),
                                jnp.asarray(noises), jnp.asarray(x),
                                jnp.asarray(y))
    t32 = convert.gp_state_from_arrays(
        {"hyperparameters": j32.covariance.hyperparameters,
         **{k: getattr(j32, k) for k in convert.GP_STATE_FIELDS[1:]}},
        "matern_2.5", dtype=torch.float32)
    unions = problem["unions"].astype(f32)
    normals = problem["normals"].astype(f32)
    v = (0.1 * rng.standard_normal((2, B, N, Q))).astype(f32)
    betas = rng.standard_normal((2, B, M, Q)).astype(f32)
    x0 = rng.random((2, B, M, 2)).astype(f32)
    params = jopt.GradientDescentParameters(
        num_multistarts=1, max_num_steps=6, max_num_restarts=2,
        num_steps_averaged=3, gamma=0.3, pre_mult=1.0,
        max_relative_change=0.1)
    jdom = JDom(bounds=jnp.asarray([[0.0, 1.0]] * 2, jnp.float32))
    tdom = TDom.from_bounds([[0.0, 1.0]] * 2, dtype=torch.float32)
    got = tkg._descent_full(t32, _t(unions, torch.float32),
                            _t(v, torch.float32), _t(betas, torch.float32),
                            _t(normals, torch.float32),
                            _t(x0, torch.float32), tdom, params,
                            "matern_2.5")
    for i in range(2):
        ref = jkg._pallas_descent_full(
            jmcmc.ensemble_member(j32, i), jnp.asarray(unions),
            jnp.asarray(v[i]), jnp.asarray(betas[i]), jnp.asarray(normals),
            jnp.asarray(x0[i]), jdom, params, "matern_2.5", interpret=True)
        np.testing.assert_allclose(got[i].numpy(), np.asarray(ref),
                                   atol=5e-5)


def _jax_batch(problem, params, inner_x0=None):
    jdom, _ = _doms()

    def f(u):
        return jkg.knowledge_gradient_mcmc_batch(
            problem["j"], u, jnp.asarray(problem["discrete"]),
            jnp.asarray(problem["normals"]), jdom, params,
            jnp.asarray(problem["best"]), Q, inner_x0=inner_x0,
            return_x_star=True)

    (vals, xs), vjp = jax.vjp(jax.jit(f), jnp.asarray(problem["unions"]))
    (grads,) = vjp((jnp.ones_like(vals), jnp.zeros_like(xs)))
    return vals, grads, xs


@pytest.mark.parametrize("mode", ["cold", "warm"])
def test_kg_batch_matches_jax(problem, mode):
    """Values, union gradients and carried endpoints of the ensemble KG
    batch, cold and in "reseed" warm mode (the same carry given to both)."""
    _, tdom = _doms()
    params = topt.GradientDescentParameters(**INNER)
    args = (problem["t"], _t(problem["unions"]), _t(problem["discrete"]),
            _t(problem["normals"]), tdom)
    carry = None
    if mode == "warm":
        _, _, carry = tkg.knowledge_gradient_mcmc_batch_vg_carry(
            *args, params, _t(problem["best"]))
        params = dataclasses.replace(params, max_num_steps=1,
                                     num_steps_averaged=0)
    v_j, g_j, x_j = _jax_batch(
        problem, jopt.GradientDescentParameters(**dataclasses.asdict(params)),
        inner_x0=None if carry is None else jnp.asarray(carry.numpy()))
    v_t, g_t, x_t = tkg.knowledge_gradient_mcmc_batch_vg_carry(
        *args, params, _t(problem["best"]), inner_x0=carry)
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j), **TOL)
    np.testing.assert_allclose(x_t.numpy(), np.asarray(x_j), **TOL)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), **GRAD)


def test_per_union_kg_matches_jax(problem):
    jdom, tdom = _doms()
    ref = jax.jit(lambda u: jkg.knowledge_gradient_mcmc(
        problem["j"], u, jnp.asarray(problem["discrete"]),
        jnp.asarray(problem["normals"]), jdom,
        jopt.GradientDescentParameters(**INNER),
        jnp.asarray(problem["best"]), Q))(jnp.asarray(problem["unions"][0]))
    got = tkg.knowledge_gradient_mcmc(
        problem["t"], _t(problem["unions"][0]), _t(problem["discrete"]),
        _t(problem["normals"]), tdom,
        topt.GradientDescentParameters(**INNER), _t(problem["best"]))
    np.testing.assert_allclose(float(got), float(ref), **TOL)


def test_optimal_posterior_mean_matches_jax(problem, rng):
    jdom, tdom = _doms()
    guesses = rng.random((S, 30, 2))
    params = dict(INNER, max_num_steps=20, gamma=0.7)
    pt_t, val_t = tkg.compute_optimal_posterior_mean(
        problem["t"], tdom, _t(guesses),
        topt.GradientDescentParameters(**params))
    opt = jax.jit(lambda s, g: jkg.compute_optimal_posterior_mean(
        s, jdom, g, jopt.GradientDescentParameters(**params)))
    for i in range(S):
        pt_j, val_j = opt(jmcmc.ensemble_member(problem["j"], i),
                          jnp.asarray(guesses[i]))
        np.testing.assert_allclose(pt_t[i].numpy(), np.asarray(pt_j), **TOL)
        np.testing.assert_allclose(float(val_t[i]), float(val_j), **TOL)
