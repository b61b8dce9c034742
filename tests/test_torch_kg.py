"""Parity of the port's q-KG (fantasy model, descent, batched and per-union
estimators, posterior-mean optimization) and of the descent kernel's plain
version with the JAX package.

Tolerances: float64 estimator values and descent endpoints at rtol 1e-9 /
atol 1e-11 and union gradients at rtol 1e-7 / atol 1e-9 (batched ==
per-union identities, tests/test_knowledge_gradient.py:50 at 1e-7); the
descent kernel's plain version in float32 against the Pallas kernel in
interpret mode at atol 5e-5 (tests/test_pallas_descent.py:64-65).

The bfloat16 fantasy solve (``config.KG_FANTASY_LOWP`` "always", float32;
the JAX package's switched by ``monkeypatch`` on its module attribute):
the fantasy model under "always" against the JAX package's under
"always" and against its own under "never", both at the bounds of
tests/test_knowledge_gradient.py:258-350 (mu 1e-4; chol_u 8e-3 and v
2e-2 of their scales; noise_eff, whose repair comes from var_u's
diagonal as chol_u does, 8e-3).  Two correct bfloat16 chains part where
their float32 residuals straddle a bfloat16 rounding boundary: one unit
in the last place of the correction, which var_u = prior - va^T va then
amplifies by its cancellation, so on this problem (cond(L) about 90 with
a derivative channel) the port and the JAX package differ by up to 0.4 of
the route's own error in v; the route's bounds are the tolerance.  The
batched KG under "always" is held within 1.5x the CRN band of three
fresh draws of normals.  The warm multistart's count of warm evaluations
(``return_stats``) equals the JAX package's exactly, its endpoints at
``SLICE`` (rtol 1e-7 / atol 1e-9, the whole-slice tolerance of
tests/test_torch_driver.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cornell_moe_tpu import config as jconfig
from cornell_moe_tpu.acquisition import knowledge_gradient as jkg
from cornell_moe_tpu.acquisition.expected_improvement import (
    draw_antithetic_normals as j_normals)
from cornell_moe_tpu.models import mcmc as jmcmc
from cornell_moe_tpu.ops import optimizers as jopt
from cornell_moe_tpu.ops.domains import TensorProductDomain as JDom
from cornell_moe_tpu.ops.domains import RepeatedDomain as JRep
from cornell_moe_tpu_torch import config, convert
from cornell_moe_tpu_torch.acquisition import knowledge_gradient as tkg
from cornell_moe_tpu_torch.acquisition.expected_improvement import (
    draw_antithetic_normals)
from cornell_moe_tpu_torch.models import mcmc as tmcmc
from cornell_moe_tpu_torch.ops import optimizers as topt
from cornell_moe_tpu_torch.ops.domains import RepeatedDomain as TRep
from cornell_moe_tpu_torch.ops.domains import TensorProductDomain as TDom

torch.set_num_threads(1)
TOL = dict(rtol=1e-9, atol=1e-11)
GRAD = dict(rtol=1e-7, atol=1e-9)
S, B, Q, M, N = 3, 3, 2, 8, 20
INNER = dict(num_multistarts=1, max_num_steps=6, max_num_restarts=1,
             num_steps_averaged=3, gamma=0.0, pre_mult=1.0,
             max_relative_change=0.1)
SLICE = dict(rtol=1e-7, atol=1e-9)


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


def test_return_x_star_matches_jax(problem):
    """``return_x_star`` (default False, as in the JAX package): without it
    both batched functions give the KG alone, bit for bit the first
    element of the return with it, and equal to the JAX package's (its
    ``knowledge_gradient_batch`` vmapped over the members: the port's
    keeps the member axis S)."""
    jdom, tdom = _doms()
    params = topt.GradientDescentParameters(**INNER)
    jparams = jopt.GradientDescentParameters(**INNER)
    args = (problem["t"], _t(problem["unions"]), _t(problem["discrete"]),
            _t(problem["normals"]), tdom, params, _t(problem["best"]))
    unions, normals = (jnp.asarray(problem[k]) for k in ("unions",
                                                         "normals"))
    refs = {
        tkg.knowledge_gradient_batch: jax.jit(jax.vmap(
            lambda s, d, b: jkg.knowledge_gradient_batch(
                s, unions, d, normals, jdom, jparams, b)))(
                    problem["j"], jnp.asarray(problem["discrete"]),
                    jnp.asarray(problem["best"])),
        tkg.knowledge_gradient_mcmc_batch: jax.jit(
            lambda: jkg.knowledge_gradient_mcmc_batch(
                problem["j"], unions, jnp.asarray(problem["discrete"]),
                normals, jdom, jparams, jnp.asarray(problem["best"]), Q))()}
    for fn, ref in refs.items():
        alone = fn(*args)
        kg, x_star = fn(*args, return_x_star=True)
        assert torch.equal(alone, kg) and x_star.shape == (S, B, M, 2)
        np.testing.assert_allclose(alone.numpy(), np.asarray(ref), **TOL)


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


@pytest.mark.parametrize("top_k", [1, 3])
def test_optimal_posterior_mean_top_k_matches_jax(problem, rng, top_k):
    """``top_k``: each member's GD from the ``top_k`` best of its guesses,
    the best end kept, against the JAX package member by member."""
    jdom, tdom = _doms()
    guesses = rng.random((S, 30, 2))
    params = dict(INNER, max_num_steps=20, gamma=0.7)
    pt_t, val_t = tkg.compute_optimal_posterior_mean(
        problem["t"], tdom, _t(guesses),
        topt.GradientDescentParameters(**params), top_k=top_k)
    opt = jax.jit(lambda s, g: jkg.compute_optimal_posterior_mean(
        s, jdom, g, jopt.GradientDescentParameters(**params), top_k=top_k))
    for i in range(S):
        pt_j, val_j = opt(jmcmc.ensemble_member(problem["j"], i),
                          jnp.asarray(guesses[i]))
        np.testing.assert_allclose(pt_t[i].numpy(), np.asarray(pt_j), **TOL)
        np.testing.assert_allclose(float(val_t[i]), float(val_j), **TOL)


# ---------------------------------------------------------------------------
# the bfloat16 fantasy solve (config.KG_FANTASY_LOWP)
# ---------------------------------------------------------------------------

def _lowp_problem(derivs):
    """tests/test_knowledge_gradient.py:258's problem in float32: 10 points
    in [-2, 2] (the first 10 of its seed-0 stream, the next 10 with a
    derivative channel, as its loop draws them), sin values (and cos
    slopes), Matern 2.5 (1.0, 0.8), noise 1e-3 per channel, 5 unions of 2
    points; an ensemble of one in both packages, the port's holding the
    JAX fit's arrays."""
    rng = np.random.default_rng(0)
    x = [rng.uniform(-2, 2, (10, 1)) for _ in range(2)][len(derivs)]
    y = np.column_stack([np.sin(x[:, 0])] +
                        ([np.cos(x[:, 0])] if derivs else []))
    j = jmcmc.fit_gp_ensemble(
        "matern_2.5", jnp.asarray([[1.0, 0.8]], jnp.float32),
        jnp.full((1, 1 + len(derivs)), 1e-3, jnp.float32),
        jnp.asarray(x, jnp.float32), jnp.asarray(y, jnp.float32),
        derivatives=derivs)
    t = convert.gp_state_from_arrays(
        {"hyperparameters": j.covariance.hyperparameters,
         **{k: getattr(j, k) for k in convert.GP_STATE_FIELDS[1:]},
         "derivatives": derivs}, "matern_2.5", dtype=torch.float32)
    unions = np.random.default_rng(3).uniform(
        -2, 2, size=(5, 2, 1)).astype(np.float32)
    return j, t, unions, y


def _fantasy_both(monkeypatch, value, j, t, unions, derivs):
    monkeypatch.setattr(jconfig, "KG_FANTASY_LOWP", value)
    monkeypatch.setattr(config, "KG_FANTASY_LOWP", value)
    ref = jax.vmap(lambda s: jkg._build_fantasy_model_batch(
        s, jnp.asarray(unions), derivs))(j)
    got = tkg._build_fantasy_model_batch(t, torch.as_tensor(unions), derivs)
    return [g.numpy() for g in got], [np.asarray(r) for r in ref]


def _within(got, ref, frac, name):
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=frac * float(np.max(np.abs(ref))),
                               err_msg=name)


@pytest.mark.parametrize("derivs", [(), (0,)], ids=["values", "d0"])
def test_fantasy_model_lowp_matches_jax(monkeypatch, derivs):
    """``_build_fantasy_model_batch`` under "always" against the JAX
    package's under "always" (float32, bfloat16 solve pair in both), and
    against "never" within tests/test_knowledge_gradient.py's bounds."""
    j, t, unions, _ = _lowp_problem(derivs)
    never, _ = _fantasy_both(monkeypatch, "never", j, t, unions, derivs)
    got, ref = _fantasy_both(monkeypatch, "always", j, t, unions, derivs)
    for against in (ref, never):
        np.testing.assert_allclose(got[0], against[0], rtol=0, atol=1e-4)
        _within(got[1], against[1], 8e-3, "chol_u")
        _within(got[2], against[2], 2e-2, "v")
        _within(got[3], against[3], 8e-3, "noise_eff")
    assert all(g.dtype == np.float32 for g in got)
    assert not np.array_equal(got[2], never[2])


@pytest.mark.parametrize("derivs", [(), (0,)], ids=["values", "d0"])
def test_batched_kg_lowp_within_the_crn_band(monkeypatch, derivs):
    """tests/test_knowledge_gradient.py:258-350 on the port: the batched
    KG's sum over the 5 unions under "always" within 1.5x the CRN band of
    "never" (its spread over three fresh draws of normals, at least 1e-3),
    and its union gradients finite and below 1e3."""
    _, t, unions, y = _lowp_problem(derivs)
    f32 = torch.float32
    dom = TDom.from_bounds([[-2.0, 2.0]], dtype=f32)
    discrete = torch.linspace(-2, 2, 9, dtype=f32)[None, :, None]
    best = torch.tensor([float(y[:, 0].min())], dtype=f32)
    inner = topt.GradientDescentParameters(
        num_multistarts=1, max_num_steps=25, max_num_restarts=1, gamma=0.7,
        pre_mult=0.5, max_relative_change=0.7)

    def normals(seed):
        return draw_antithetic_normals(torch.Generator().manual_seed(seed),
                                       16, 2 * (1 + len(derivs)), dtype=f32)

    def vg(nm):
        with torch.enable_grad():
            u = torch.as_tensor(unions).requires_grad_(True)
            kg = tkg.knowledge_gradient_batch(
                t, u, discrete, nm, dom, inner, best,
                derivatives_to_sample=derivs)
            (g,) = torch.autograd.grad(kg.sum(), u)
        return float(kg.sum().detach()), g

    monkeypatch.setattr(config, "KG_FANTASY_LOWP", "never")
    v_ref, _ = vg(normals(7))
    crn = [vg(normals(100 + s))[0] for s in range(3)]
    band = max(np.max(np.abs(np.asarray(crn) - v_ref)), 1e-3)
    monkeypatch.setattr(config, "KG_FANTASY_LOWP", "always")
    v_lp, g_lp = vg(normals(7))
    assert abs(v_lp - v_ref) < 1.5 * band, (v_ref, v_lp, band, crn)
    assert bool(torch.isfinite(g_lp).all())
    assert float(g_lp.abs().max()) < 1e3


@pytest.mark.parametrize("conv_tol, chunk", [(None, 4), (5e-3, 4),
                                             (5e-3, None)])
def test_warm_multistart_stats_match_jax(conv_tol, chunk):
    """``multistart_optimize_batched_warm(return_stats=True)`` on the warm
    multistart of tests/test_kg_warm_start.py:200 (1-d GP, 2 members, 8
    starts, 12 steps, 2 rounds), fixed-depth and gated, in chunks of 4 and
    in one batch: the warm evaluations (per chunk, or one count for the
    batch) equal the JAX package's exactly, and the endpoints agree at
    ``SLICE``."""
    rng = np.random.default_rng(0)
    x = rng.uniform(-2, 2, size=(8, 1))
    y = np.sin(1.3 * x[:, 0]) + 0.05 * rng.standard_normal(8)
    hypers = np.asarray([[1.0, 0.7], [1.3, 0.9]])
    noises = np.full((2, 1), 1e-3)
    jstates = jmcmc.fit_gp_ensemble("matern_2.5", hypers, noises, x,
                                    y[:, None])
    tstates = tmcmc.fit_gp_ensemble("matern_2.5", _t(hypers), _t(noises), x,
                                    y[:, None])
    outer = dict(num_multistarts=8, max_num_steps=12, max_num_restarts=2,
                 num_steps_averaged=3, gamma=0.7, pre_mult=0.4,
                 max_relative_change=0.5)
    inner = dict(num_multistarts=1, max_num_steps=5, max_num_restarts=1,
                 num_steps_averaged=0, gamma=0.0, pre_mult=0.5,
                 max_relative_change=0.2)
    warm = dict(inner, max_num_steps=2)
    jdom = JDom.from_bounds([[-2.0, 2.0]])
    jrep = JRep(domain=jdom, num_repeats=2)
    discrete = np.tile(np.linspace(-2, 2, 7)[None, :, None], (2, 1, 1))
    normals = np.asarray(j_normals(jax.random.PRNGKey(5), 16, 2))
    starts = np.asarray(jrep.generate_latin_hypercube_points(
        jax.random.PRNGKey(2), 8))
    bsf = np.asarray([float(y.min())] * 2)
    jp = {k: jopt.GradientDescentParameters(**v)
          for k, v in (("cold", inner), ("warm", warm), ("outer", outer))}
    tp = {k: topt.GradientDescentParameters(**v)
          for k, v in (("cold", inner), ("warm", warm), ("outer", outer))}

    jargs = (jnp.asarray(discrete), jnp.asarray(normals), jdom)
    ref, ref_evals = jopt.multistart_optimize_batched_warm(
        lambda p: jkg.knowledge_gradient_mcmc_batch_vg_carry(
            jstates, p, *jargs, jp["cold"], jnp.asarray(bsf), 2),
        lambda p, c: jkg.knowledge_gradient_mcmc_batch_vg_carry(
            jstates, p, *jargs, jp["warm"], jnp.asarray(bsf), 2,
            inner_x0=c, warm_mode="reseed"),
        jrep, jnp.asarray(starts), jp["outer"], chunk_size=chunk,
        conv_tol=conv_tol, return_stats=True)

    tdom = TDom.from_bounds([[-2.0, 2.0]])
    targs = (_t(discrete), _t(normals), tdom)
    got, evals = topt.multistart_optimize_batched_warm(
        lambda p: tkg.knowledge_gradient_mcmc_batch_vg_carry(
            tstates, p, *targs, tp["cold"], _t(bsf)),
        lambda p, c: tkg.knowledge_gradient_mcmc_batch_vg_carry(
            tstates, p, *targs, tp["warm"], _t(bsf), inner_x0=c),
        TRep(domain=tdom, num_repeats=2), _t(starts), tp["outer"],
        chunk_size=chunk, conv_tol=conv_tol, return_stats=True)
    assert evals.dtype == torch.int32
    assert evals.shape == np.asarray(ref_evals).shape
    np.testing.assert_array_equal(evals.numpy(), np.asarray(ref_evals))
    if conv_tol is None:
        assert evals.tolist() == [11 + 12] * 2
    np.testing.assert_allclose(got.all_points.numpy(),
                               np.asarray(ref.all_points), **SLICE)
