"""Parity of the port's MC q-EI (single, batched, ensemble, value+grad and
the batched multistart) with the JAX package, in float64, with the same
normals and starts passed to both; in float32, an indefinite union's
estimate NaN in both packages, and the single-union and batched estimates
equal on the same union posteriors.

Tolerances: rtol 1e-10 / atol 1e-13 for estimator values and rtol 1e-9 /
atol 1e-12 for gradients (tests/test_expected_improvement.py:297,317); the
multistart endpoints at 1e-7 (same arithmetic, 10 GD steps); the entry
point's per-start route against its batched route and against the JAX
package's per-start route at rtol 1e-9 / atol 1e-12, the JAX test's own
bound (tests/test_expected_improvement.py:300-317).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cornell_moe_tpu.acquisition import expected_improvement as jei
from cornell_moe_tpu.models import mcmc as jmcmc
from cornell_moe_tpu.ops import optimizers as jopt
from cornell_moe_tpu.ops.domains import RepeatedDomain as JRep
from cornell_moe_tpu.ops.domains import TensorProductDomain as JDom
from cornell_moe_tpu_torch.acquisition import expected_improvement as tei
from cornell_moe_tpu_torch.models import mcmc as tmcmc
from cornell_moe_tpu_torch.ops import optimizers as topt
from cornell_moe_tpu_torch.ops.domains import RepeatedDomain as TRep
from cornell_moe_tpu_torch.ops.domains import TensorProductDomain as TDom

torch.set_num_threads(1)
VAL = dict(rtol=1e-10, atol=1e-13)
GRAD = dict(rtol=1e-9, atol=1e-12)


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


@pytest.fixture
def ensembles(rng):
    x = rng.random((20, 2))
    y = (np.sin(3 * x[:, 0]) + x[:, 1])[:, None]
    hypers = np.concatenate([0.8 + rng.random((3, 1)),
                             0.3 + 0.4 * rng.random((3, 2))], axis=1)
    noises = np.full((3, 1), 1e-2)
    j = jmcmc.fit_gp_ensemble("matern_2.5", jnp.asarray(hypers),
                              jnp.asarray(noises), x, y)
    t = tmcmc.fit_gp_ensemble("matern_2.5", _t(hypers), _t(noises), x, y)
    return j, t


def test_antithetic_normals_pairs():
    z = tei.draw_antithetic_normals(torch.Generator().manual_seed(0), 7, 3)
    assert z.shape == (7, 3)
    torch.testing.assert_close(z[1::2], -z[0:6:2])


def test_single_and_batch_estimators_match_jax(ensembles, rng):
    j, t = ensembles
    normals = rng.standard_normal((64, 3))
    union = rng.random((3, 2))
    member = jmcmc.ensemble_member(j, 1)
    ref = jei.monte_carlo_expected_improvement(
        member, jnp.asarray(union), None, 0.1, jnp.asarray(normals))
    got = tei.monte_carlo_expected_improvement(
        t.member(1), _t(union), None, 0.1, _t(normals))
    np.testing.assert_allclose(float(got), float(ref), **VAL)

    unions = rng.random((4, 3, 2))
    ref_b = jei.monte_carlo_expected_improvement_batch(
        member, jnp.asarray(unions), 0.1, jnp.asarray(normals))
    got_b = tei.monte_carlo_expected_improvement_batch(
        t.member(1), _t(unions), 0.1, _t(normals))
    np.testing.assert_allclose(got_b.numpy(), np.asarray(ref_b), **VAL)


def test_ensemble_value_and_grad_match_jax(ensembles, rng):
    j, t = ensembles
    normals = rng.standard_normal((64, 2))
    pts = rng.random((5, 2, 2))
    best = np.array([0.1, -0.2, 0.0])
    v_j, g_j = jax.jit(
        lambda p: jei.expected_improvement_mcmc_batch_value_and_grad(
            j, p, None, jnp.asarray(best), jnp.asarray(normals)))(
                jnp.asarray(pts))
    v_t, g_t = tei.expected_improvement_mcmc_batch_value_and_grad(
        t, _t(pts), None, _t(best), _t(normals))
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j), **VAL)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), **GRAD)
    single = tei.monte_carlo_expected_improvement_mcmc(
        t, _t(pts[0]), None, _t(best), _t(normals))
    np.testing.assert_allclose(float(single), float(v_t[0]), **VAL)


def test_batched_multistart_matches_jax(ensembles, rng):
    """The seeding q-EI multistart, gated, from the same starts."""
    j, t = ensembles
    normals = rng.standard_normal((32, 2))
    starts = rng.random((6, 2, 2))
    best = np.array([0.1, -0.2, 0.0])
    params = dict(num_multistarts=6, max_num_steps=5, max_num_restarts=2,
                  num_steps_averaged=2, gamma=0.7, pre_mult=1.0,
                  max_relative_change=0.5)
    jd = JRep(domain=JDom.from_bounds([[0.0, 1.0]] * 2), num_repeats=2)
    td = TRep(domain=TDom.from_bounds([[0.0, 1.0]] * 2), num_repeats=2)

    def bvg_j(p):
        return jei.expected_improvement_mcmc_batch_value_and_grad(
            j, p, None, jnp.asarray(best), jnp.asarray(normals))

    def bvg_t(p):
        return tei.expected_improvement_mcmc_batch_value_and_grad(
            t, p, None, _t(best), _t(normals))

    res_j = jopt.multistart_optimize_batched(
        bvg_j, jd, jnp.asarray(starts), jopt.GradientDescentParameters(
            **params), chunk_size=3, conv_tol=1e-3)
    res_t = topt.multistart_optimize_batched(
        bvg_t, td, _t(starts), topt.GradientDescentParameters(**params),
        chunk_size=3, conv_tol=1e-3)
    np.testing.assert_allclose(res_t.all_points.numpy(),
                               np.asarray(res_j.all_points), rtol=1e-7,
                               atol=1e-9)
    np.testing.assert_allclose(res_t.best_point.numpy(),
                               np.asarray(res_j.best_point), rtol=1e-7)


@pytest.mark.parametrize("conv_tol", [None, 1e-3])
def test_per_start_multistart_matches_jax(ensembles, rng, conv_tol):
    """Per-start multistart (each start its own trajectory and gate) on the
    ensemble-mean q-EI of one point, from the same starts."""
    j, t = ensembles
    normals = rng.standard_normal((16, 1))
    starts = rng.random((4, 1, 2))
    best = np.array([0.1, -0.2, 0.0])
    params = dict(num_multistarts=4, max_num_steps=6, max_num_restarts=2,
                  num_steps_averaged=3, gamma=0.7, pre_mult=1.0,
                  max_relative_change=0.5)
    jd = JRep(domain=JDom.from_bounds([[0.0, 1.0]] * 2), num_repeats=1)
    td = TRep(domain=TDom.from_bounds([[0.0, 1.0]] * 2), num_repeats=1)

    def vg_j(p):
        return jax.value_and_grad(
            lambda pp: jei.monte_carlo_expected_improvement_mcmc(
                j, pp, None, jnp.asarray(best), jnp.asarray(normals)))(p)

    def vg_t(p):
        with torch.enable_grad():
            pp = p.detach().requires_grad_(True)
            v = tei.monte_carlo_expected_improvement_mcmc(
                t, pp, None, _t(best), _t(normals))
            (g,) = torch.autograd.grad(v, pp)
        return v.detach(), g

    res_j = jopt.multistart_optimize(
        vg_j, jd, jnp.asarray(starts), jopt.GradientDescentParameters(
            **params), conv_tol=conv_tol)
    res_t = topt.multistart_optimize(
        vg_t, td, _t(starts), topt.GradientDescentParameters(**params),
        conv_tol=conv_tol)
    np.testing.assert_allclose(res_t.all_points.numpy(),
                               np.asarray(res_j.all_points), rtol=1e-7,
                               atol=1e-9)
    np.testing.assert_allclose(res_t.all_values.numpy(),
                               np.asarray(res_j.all_values), rtol=1e-7,
                               atol=1e-12)


def test_multistart_entry_point_runs(ensembles):
    _, t = ensembles
    dom = TDom.from_bounds([[0.0, 1.0]] * 2)
    pts = tei.multistart_expected_improvement_mcmc_optimization(
        torch.Generator().manual_seed(0), t, dom, 3,
        topt.GradientDescentParameters(num_multistarts=4, max_num_steps=3,
                                       num_steps_averaged=2),
        num_mc_iterations=16, conv_tol=1e-3)
    assert pts.shape == (3, 2)
    assert bool(dom.check_point_inside(pts).all())


def test_per_start_entry_point_matches_batched_and_jax(monkeypatch):
    """``multistart_expected_improvement_mcmc_optimization(use_batched=
    False)`` at the JAX test's size (tests/test_expected_improvement.py
    :300-317: 3 members, 12 points, 8 starts, 6 steps, q = 2, 64 draws),
    the port's starts and normals those the JAX package draws from its
    key: against the port's batched route and the JAX package's per-start
    route."""
    r = np.random.default_rng(7)
    x = r.random((12, 2))
    y = (np.sin(3 * x[:, 0]) + x[:, 1] ** 2)[:, None]
    hypers = np.abs(r.standard_normal((3, 3))) + 0.7
    noises = np.full((3, 1), 1e-3)
    j = jmcmc.fit_gp_ensemble("matern_2.5", jnp.asarray(hypers),
                              jnp.asarray(noises), jnp.asarray(x),
                              jnp.asarray(y))
    t = tmcmc.fit_gp_ensemble("matern_2.5", _t(hypers), _t(noises), x, y)
    params = dict(num_multistarts=8, max_num_steps=6, max_num_restarts=1,
                  num_steps_averaged=3, gamma=0.7, pre_mult=0.3,
                  max_relative_change=0.5)
    box = [[0.0, 1.0], [0.0, 1.0]]
    key = jax.random.PRNGKey(5)
    key_start, key_mc = jax.random.split(key)
    starts = np.asarray(JRep(domain=JDom.from_bounds(box), num_repeats=2)
                        .generate_latin_hypercube_points(key_start, 8))
    normals = np.asarray(jei.draw_normals(key_mc, 64, 2))

    def lhs(self, generator, num_points):
        assert (num_points, self.num_repeats) == starts.shape[:2]
        return _t(starts)

    def draws(generator, num_mc, n, device=None, dtype=None):
        assert (num_mc, n) == normals.shape
        return _t(normals)

    monkeypatch.setattr(TRep, "generate_latin_hypercube_points", lhs)
    monkeypatch.setattr(tei, "draw_normals", draws)
    got = {batched: tei.multistart_expected_improvement_mcmc_optimization(
        torch.Generator().manual_seed(0), t, TDom.from_bounds(box), 2,
        topt.GradientDescentParameters(**params), num_mc_iterations=64,
        use_batched=batched) for batched in (True, False)}
    ref = jei.multistart_expected_improvement_mcmc_optimization(
        key, j, JDom.from_bounds(box), 2,
        jopt.GradientDescentParameters(**params), num_mc_iterations=64,
        use_batched=False)
    np.testing.assert_allclose(got[False].numpy(), got[True].numpy(),
                               **GRAD)
    np.testing.assert_allclose(got[False].numpy(), np.asarray(ref), **GRAD)


def _float32_union_covariances(rng, b, u, indefinite):
    """b symmetric (u, u) float32 covariances: positive definite, except
    at the indices ``indefinite``, whose least eigenvalue is -0.05 (far
    below -EI_VARIANCE_JITTER)."""
    out = np.empty((b, u, u))
    for i in range(b):
        q, _ = np.linalg.qr(rng.standard_normal((u, u)))
        lam = 0.05 + rng.random(u)
        if i in indefinite:
            lam[0] = -0.05
        v = (q * lam) @ q.T
        out[i] = 0.5 * (v + v.T)
    return out.astype(np.float32)


def test_indefinite_float32_union_is_nan_as_in_jax(rng):
    """An indefinite float32 union covariance and the same normals through
    the JAX package's estimator arithmetic (``add_jitter`` of
    ``EI_VARIANCE_JITTER``, ``cholesky_small``, ``hdot``) and the port's
    single-union estimate: both NaN, as is the port's batched one (no
    lift of the diagonal by the least eigenvalue, which would make it
    finite: the JAX package has none)."""
    from cornell_moe_tpu import config as jconfig
    from cornell_moe_tpu.ops import linalg as jlinalg

    var = _float32_union_covariances(rng, 1, 4, {0})[0]
    assert np.linalg.eigvalsh(var.astype(float))[0] < -1e3 * \
        jconfig.EI_VARIANCE_JITTER
    mu = rng.standard_normal(4).astype(np.float32)
    normals = rng.standard_normal((64, 4)).astype(np.float32)
    best = np.float32(mu.min())
    chol = jlinalg.cholesky_small(jlinalg.add_jitter(
        jnp.asarray(var), jconfig.EI_VARIANCE_JITTER))
    samples = jnp.asarray(mu)[None, :] + jlinalg.hdot(jnp.asarray(normals),
                                                      chol.T)
    ref = jnp.mean(jnp.maximum(best - jnp.min(samples, axis=1), 0.0))
    assert ref.dtype == jnp.float32 and np.isnan(float(ref))
    f32 = dict(dtype=torch.float32)
    got = tei._estimate_from_posterior(
        torch.as_tensor(mu, **f32), torch.as_tensor(var, **f32),
        torch.as_tensor(best, **f32), torch.as_tensor(normals, **f32))
    assert got.dtype == torch.float32 and bool(torch.isnan(got))
    batched = tei._estimate_batch(
        torch.as_tensor(mu[None], **f32), torch.as_tensor(var[None], **f32),
        torch.as_tensor(best, **f32), torch.as_tensor(normals, **f32))
    assert bool(torch.isnan(batched).all())


def test_single_union_and_batched_estimates_agree_in_float32(rng):
    """The single-union estimate (the VOI's and the per-start route's) and
    the batched one (the batched route's) on the same float32 (mu, var)
    of 40 unions of 4 points, 128 normals: NaN at the same unions (the
    indefinite ones) and equal elsewhere within float32 rounding (rtol
    1e-5, atol 1e-6 on values of order 1: the two form the samples by a
    matmul and an einsum)."""
    b, u = 40, 4
    bad = {3, 17, 29}
    f32 = dict(dtype=torch.float32)
    var = torch.as_tensor(_float32_union_covariances(rng, b, u, bad), **f32)
    mu = torch.as_tensor(rng.standard_normal((b, u)), **f32)
    normals = torch.as_tensor(rng.standard_normal((128, u)), **f32)
    best = torch.as_tensor(0.5, **f32)
    single = tei._estimate_from_posterior(mu, var, best, normals)
    batched = tei._estimate_batch(mu, var, best, normals)
    nan = [i for i in range(b) if bool(torch.isnan(single[i]))]
    assert nan == sorted(bad)
    assert torch.equal(torch.isnan(batched), torch.isnan(single))
    np.testing.assert_allclose(single.numpy(), batched.numpy(), rtol=1e-5,
                               atol=1e-6, equal_nan=True)
