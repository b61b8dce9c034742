"""The port's single-GP KG surface, its points-being-sampled repair of the
ensemble KG and three dense linear-algebra helpers, against the JAX package
in float64 on the CPU.

The single-GP functions (``knowledge_gradient_value_and_grad``,
``multistart_knowledge_gradient_optimization``,
``posterior_mean_optimization``) run one GP as an ensemble of one on the
per-union route.  The ensemble multistart takes ``points_being_sampled``
through its three routes (warm gated-batched, cold batched, per-start):
each union is the start block followed by the points being sampled, the
gradient moves the start block alone and the fidelity cost counts it
alone (``knowledge_gradient_mcmc``'s ``num_to_sample``).  Where the JAX
package draws its own starts and normals from a key, the test gives the
port the same draws in place of its generator's.

Tolerances: KG values at rtol 1e-9 / atol 1e-11 and gradients at rtol 1e-7
/ atol 1e-9 (tests/test_knowledge_gradient.py:50, as
tests/test_torch_kg.py holds the per-union estimator); multistart picks at
rtol 1e-7 / atol 1e-9 (as tests/test_torch_driver.py holds the q-KG
slice); the posterior-mean optimum at rtol 1e-9 / atol 1e-11; the linear
algebra at rtol 1e-12, NaN where a factorization fails in both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cornell_moe_tpu.acquisition import expected_improvement as jei
from cornell_moe_tpu.acquisition import knowledge_gradient as jkg
from cornell_moe_tpu.models import mcmc as jmcmc
from cornell_moe_tpu.ops import linalg as jlinalg
from cornell_moe_tpu.ops import optimizers as jopt
from cornell_moe_tpu.ops.domains import RepeatedDomain as JRep
from cornell_moe_tpu.ops.domains import TensorProductDomain as JDom
from cornell_moe_tpu.utils import synthetic_functions as jsf
from cornell_moe_tpu_torch.acquisition import knowledge_gradient as tkg
from cornell_moe_tpu_torch.models import mcmc as tmcmc
from cornell_moe_tpu_torch.ops import linalg as tlinalg
from cornell_moe_tpu_torch.ops import optimizers as topt
from cornell_moe_tpu_torch.ops.domains import RepeatedDomain as TRep
from cornell_moe_tpu_torch.ops.domains import TensorProductDomain as TDom

torch.set_num_threads(1)
TOL = dict(rtol=1e-9, atol=1e-11)
GRAD = dict(rtol=1e-7, atol=1e-9)
PICKS = dict(rtol=1e-7, atol=1e-9)
S, Q, P, M, N, NSTART = 3, 2, 1, 8, 12, 4
BOX = [[0.0, 1.0]] * 2
INNER = dict(num_multistarts=1, max_num_steps=4, max_num_restarts=1,
             num_steps_averaged=2, gamma=0.0, pre_mult=1.0,
             max_relative_change=0.1)
OUTER = dict(num_multistarts=NSTART, max_num_steps=3, max_num_restarts=1,
             num_steps_averaged=0, gamma=0.7, pre_mult=0.4,
             max_relative_change=0.5)


def _t(a):
    return torch.as_tensor(np.array(a), dtype=torch.float64)


def _close(got, ref, tol, err_msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(ref), err_msg=err_msg, **tol)


@pytest.fixture(scope="module")
def ens():
    r = np.random.default_rng(0)
    x = r.random((N, 2))
    y = (np.sin(3 * x[:, 0]) + x[:, 1])[:, None]
    hypers = np.concatenate([0.8 + r.random((S, 1)),
                             0.3 + 0.4 * r.random((S, 2))], axis=1)
    noises = np.full((S, 1), 1e-2)
    return dict(
        j=jmcmc.fit_gp_ensemble("matern_2.5", jnp.asarray(hypers),
                                jnp.asarray(noises), x, y),
        t=tmcmc.fit_gp_ensemble("matern_2.5", _t(hypers), _t(noises), x, y),
        discrete=r.random((S, 5, 2)), being=r.random((P, 2)),
        pts=r.random((Q, 2)))


@pytest.fixture(scope="module")
def member(ens):
    return jmcmc.ensemble_member(ens["j"], 0), ens["t"].member(0)


def _jax_draws(key, q_union, dim, num_to_sample=Q):
    """The starts and normals a JAX multistart draws from ``key``."""
    key_start, key_mc = jax.random.split(key)
    rep = JRep(domain=JDom.from_bounds([[0.0, 1.0]] * dim),
               num_repeats=num_to_sample)
    return (np.asarray(rep.generate_latin_hypercube_points(key_start,
                                                           NSTART)),
            np.asarray(jei.draw_antithetic_normals(key_mc, M, q_union)))


def _give_draws(monkeypatch, starts, normals):
    """The port's multistart takes these draws in place of its
    generator's, after checking the shapes it asks for."""
    def lhs(self, generator, num_points):
        assert (num_points, self.num_repeats) == starts.shape[:2]
        return _t(starts)

    def antithetic(generator, num_mc, n, device=None, dtype=None):
        assert (num_mc, n) == normals.shape
        return _t(normals)

    monkeypatch.setattr(TRep, "generate_latin_hypercube_points", lhs)
    monkeypatch.setattr(tkg, "draw_antithetic_normals", antithetic)


# ---------------------------------------------------------------------------
# ops/linalg.py additions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["spd_solve", "spd_solve_jitter",
                                  "batched_cholesky", "failed_cholesky",
                                  "lower_triangular_only"])
def test_linalg_additions_match_jax(rng, case):
    a = rng.standard_normal((3, 6, 6))
    spd = a @ np.swapaxes(a, -1, -2) + 6 * np.eye(6)
    rhs = rng.standard_normal((3, 6, 2))
    if case.startswith("spd_solve"):
        jitter = 0.3 if case.endswith("jitter") else 0.0
        ref = jlinalg.spd_solve(jnp.asarray(spd), jnp.asarray(rhs), jitter)
        got = tlinalg.spd_solve(_t(spd), _t(rhs), jitter)
    elif case == "lower_triangular_only":
        ref = jlinalg.lower_triangular_only(jnp.asarray(a))
        got = tlinalg.lower_triangular_only(_t(a))
    else:
        if case == "failed_cholesky":
            spd[1] = -np.eye(6)
        # a failed factor is NaN over its lower triangle in both (the
        # JAX package's strict upper triangle stays 0)
        ref = np.tril(np.asarray(jlinalg.batched_cholesky(
            jnp.asarray(spd), 1e-3)))
        got = torch.tril(tlinalg.batched_cholesky(_t(spd), 1e-3))
        failed = np.isnan(ref[1][np.tril_indices(6)]).all()
        assert failed == (case == "failed_cholesky")
    ref = np.asarray(ref)
    np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(ref))
    _close(torch.nan_to_num(got), np.nan_to_num(ref), dict(rtol=1e-12,
                                                           atol=1e-14))


# ---------------------------------------------------------------------------
# the single-GP surface
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("being", [False, True], ids=["q", "q_plus_p"])
def test_single_gp_kg_value_and_grad_match_jax(ens, member, being):
    """One GP's KG and its gradient with respect to the points to sample,
    with and without a point being sampled in the union."""
    j, t = member
    bs = ens["being"] if being else None
    normals = np.random.default_rng(1).standard_normal((M, Q + P * being))
    disc = ens["discrete"][0]
    jdom, tdom = JDom.from_bounds(BOX), TDom.from_bounds(BOX)
    v_j, g_j = jax.jit(lambda: jkg.knowledge_gradient_value_and_grad(
        j, jnp.asarray(ens["pts"]), bs, jnp.asarray(disc),
        jnp.asarray(normals), jdom, jopt.GradientDescentParameters(**INNER),
        0.1))()
    v_t, g_t = tkg.knowledge_gradient_value_and_grad(
        t, _t(ens["pts"]), None if bs is None else _t(bs), _t(disc),
        _t(normals), tdom, topt.GradientDescentParameters(**INNER), 0.1)
    assert g_t.shape == (Q, 2)
    _close(v_t, v_j, TOL)
    _close(g_t, g_j, GRAD)


@pytest.mark.parametrize("being", [False, True], ids=["q", "q_plus_p"])
def test_single_gp_kg_multistart_matches_jax(monkeypatch, ens, member,
                                             being):
    """The single-GP per-start multistart from the JAX key's starts and
    normals: the normals span the union's q + p points."""
    j, t = member
    bs = ens["being"] if being else None
    key = jax.random.PRNGKey(3)
    starts, normals = _jax_draws(key, Q + P * being, 2)
    disc = ens["discrete"][0]
    ref = jax.jit(lambda: jkg.multistart_knowledge_gradient_optimization(
        key, j, JDom.from_bounds(BOX), Q,
        jopt.GradientDescentParameters(**OUTER),
        jopt.GradientDescentParameters(**INNER), jnp.asarray(disc),
        points_being_sampled=bs, num_mc_iterations=M))()
    _give_draws(monkeypatch, starts, normals)
    got = tkg.multistart_knowledge_gradient_optimization(
        torch.Generator().manual_seed(0), t, TDom.from_bounds(BOX), Q,
        topt.GradientDescentParameters(**OUTER),
        topt.GradientDescentParameters(**INNER), _t(disc),
        points_being_sampled=None if bs is None else _t(bs),
        num_mc_iterations=M)
    assert got.shape == (Q, 2)
    _close(got, ref, PICKS)


@pytest.mark.parametrize("top_k", [1, 3])
def test_posterior_mean_optimization_matches_jax(member, top_k):
    j, t = member
    guesses = np.random.default_rng(2).random((7, 2))
    params = dict(INNER, max_num_steps=20, max_relative_change=0.3)
    pt_j, v_j = jax.jit(lambda: jkg.posterior_mean_optimization(
        j, JDom.from_bounds(BOX), jopt.GradientDescentParameters(**params),
        jnp.asarray(guesses), top_k=top_k))()
    pt_t, v_t = tkg.posterior_mean_optimization(
        t, TDom.from_bounds(BOX), topt.GradientDescentParameters(**params),
        _t(guesses), top_k=top_k)
    _close(pt_t, pt_j, TOL)
    _close(v_t, v_j, TOL)


# ---------------------------------------------------------------------------
# points being sampled in the ensemble multistart
# ---------------------------------------------------------------------------

ROUTES = {"warm": dict(use_batched=True, warm_start=True, chunk_size=2,
                       conv_tol=3e-3),
          "batched": dict(use_batched=True, warm_start=False, chunk_size=2),
          "per_start": dict(use_batched=False)}


@pytest.mark.parametrize("route", list(ROUTES))
def test_ensemble_multistart_with_points_being_sampled_matches_jax(
        monkeypatch, ens, route):
    """The three routes of the ensemble multistart with one point being
    sampled: the JAX key's starts (q points) and normals (q + p columns)
    given to both packages."""
    key = jax.random.PRNGKey(5)
    starts, normals = _jax_draws(key, Q + P, 2)
    kw = ROUTES[route]
    ref = jax.jit(lambda: jkg.multistart_knowledge_gradient_mcmc_optimization(
        key, ens["j"], JDom.from_bounds(BOX), Q,
        jopt.GradientDescentParameters(**OUTER),
        jopt.GradientDescentParameters(**INNER),
        jnp.asarray(ens["discrete"]), points_being_sampled=ens["being"],
        num_mc_iterations=M, **kw))()
    _give_draws(monkeypatch, starts, normals)
    got = tkg.multistart_knowledge_gradient_mcmc_optimization(
        torch.Generator().manual_seed(0), ens["t"], TDom.from_bounds(BOX), Q,
        topt.GradientDescentParameters(**OUTER),
        topt.GradientDescentParameters(**INNER), _t(ens["discrete"]),
        points_being_sampled=_t(ens["being"]), num_mc_iterations=M, **kw)
    assert got.shape == (Q, 2)
    _close(got, ref, PICKS)


@pytest.fixture(scope="module")
def fidelity():
    """An ensemble on BraninFidelity (d = 3, the last coordinate a
    fidelity in [0.05, 1])."""
    r = np.random.default_rng(7)
    f = jsf.BraninFidelity()
    box = np.asarray(f._search_domain)
    x = box[:, 0] + r.random((N, 3)) * (box[:, 1] - box[:, 0])
    y = np.array([float(np.asarray(f.evaluate_true(p))[0]) for p in x])
    y = ((y - y.mean()) / y.std())[:, None]
    hypers = np.concatenate([0.8 + r.random((S, 1)),
                             np.array([[4.0, 4.0, 0.5]]) *
                             (0.6 + 0.4 * r.random((S, 3)))], axis=1)
    noises = np.full((S, 1), 1e-2)
    union = box[:, 0] + r.random((Q + P, 3)) * (box[:, 1] - box[:, 0])
    return dict(
        j=jmcmc.fit_gp_ensemble("matern_2.5", jnp.asarray(hypers),
                                jnp.asarray(noises), x, y),
        t=tmcmc.fit_gp_ensemble("matern_2.5", _t(hypers), _t(noises), x, y),
        box=box, union=union, unions=np.stack([union, union[::-1]]),
        discrete=box[None, None, :2, 0] + r.random((S, 5, 2)) *
        (box[:2, 1] - box[:2, 0]),
        normals=r.standard_normal((M, Q + P)), best=np.zeros(S))


def test_fidelity_cost_counts_the_points_to_sample_only(fidelity):
    """cf-KG with a point being sampled: the cost is the first q points'
    (num_to_sample) and differs from the whole union's; the per-union
    value and gradient and the batched values and (q + p)-point gradients
    match the JAX package's."""
    f = fidelity
    u = f["union"]
    assert not np.isclose(np.max(u[:Q, 2]), np.max(u[:, 2]))
    jinner = JDom.from_bounds(f["box"][:2])
    tinner = TDom.from_bounds(f["box"][:2])
    jp, tp = jopt.GradientDescentParameters(**INNER), \
        topt.GradientDescentParameters(**INNER)
    disc, normals, best = f["discrete"], f["normals"], f["best"]

    def jax_kg(x):
        return jkg.knowledge_gradient_mcmc(
            f["j"], jnp.concatenate([x, jnp.asarray(u[Q:])]),
            jnp.asarray(disc), jnp.asarray(normals), jinner, jp,
            jnp.asarray(best), Q, 1)

    v_j, g_j = jax.jit(jax.value_and_grad(jax_kg))(jnp.asarray(u[:Q]))
    x = _t(u[:Q]).requires_grad_(True)
    v_t = tkg.knowledge_gradient_mcmc(
        f["t"], torch.cat([x, _t(u[Q:])]), _t(disc), _t(normals), tinner,
        tp, _t(best), num_fidelity=1, num_to_sample=Q)
    (g_t,) = torch.autograd.grad(v_t, x)
    _close(v_t, v_j, TOL)
    _close(g_t, g_j, GRAD)
    whole = tkg.knowledge_gradient_mcmc(
        f["t"], _t(u), _t(disc), _t(normals), tinner, tp, _t(best),
        num_fidelity=1)
    assert not np.isclose(float(whole), float(v_t.detach()))

    vb_j, gb_j, _ = jax.jit(lambda: jkg.knowledge_gradient_mcmc_batch_vg_carry(
        f["j"], jnp.asarray(f["unions"]), jnp.asarray(disc),
        jnp.asarray(normals), jinner, jp, jnp.asarray(best), Q, 1))()
    vb_t, gb_t, _ = tkg.knowledge_gradient_mcmc_batch_vg_carry(
        f["t"], _t(f["unions"]), _t(disc), _t(normals), tinner, tp,
        _t(best), num_fidelity=1, num_to_sample=Q)
    _close(vb_t, vb_j, TOL)
    _close(gb_t, gb_j, GRAD)


def test_descent_gate_reads_the_union_width():
    """Kernel A's gate takes the union's width q + p: a union that fits
    the kernel with its points being sampled goes to the kernel, one that
    does not only with them (q + p = 17) goes to the plain route, on a CUDA
    float32 state (the gate reads no tensor)."""
    def gate(q):
        return tkg.descent_kernel_for("cuda", torch.float32, "matern_2.5",
                                      (), (), 2, q)
    assert gate(Q + P) == "matern_2.5"
    assert gate(16) == "matern_2.5" and gate(16 + P) is None
