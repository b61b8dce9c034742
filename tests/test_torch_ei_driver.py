"""Method "EI" and the driver's extras, against the JAX package in float64
on the CPU: the point-list evaluators, EI values and gradients, the
single-GP multistart's three routes, the estimation policies and heuristic
q-EI, the "pure" warm KG mode, the whole EI slice (member 0's multistart,
the VOI and the recommendation), then the driver (method "EI", its
checkpoint and resume, the sampling helpers) and the command line.

Each test feeds the same numpy inputs, made from a seed, to both packages;
where the JAX package draws its own starts or normals, the test passes the
same ones to both.  Tolerance: ``TOL`` (rtol 1e-7, atol 1e-9), as
tests/test_torch_driver.py; estimator values and gradients at the
tolerances of tests/test_torch_ei.py (``VAL``, ``GRAD``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cornell_moe_tpu.acquisition import expected_improvement as jei
from cornell_moe_tpu.acquisition import knowledge_gradient as jkg
from cornell_moe_tpu.models import mcmc as jmcmc
from cornell_moe_tpu.ops import optimizers as jopt
from cornell_moe_tpu.ops.domains import RepeatedDomain as JRep
from cornell_moe_tpu.ops.domains import TensorProductDomain as JDom
from cornell_moe_tpu_torch import bayes_opt as tbo
from cornell_moe_tpu_torch import main as cli
from cornell_moe_tpu_torch.acquisition import expected_improvement as tei
from cornell_moe_tpu_torch.acquisition import knowledge_gradient as tkg
from cornell_moe_tpu_torch.models import mcmc as tmcmc
from cornell_moe_tpu_torch.ops import optimizers as topt
from cornell_moe_tpu_torch.ops.domains import RepeatedDomain as TRep
from cornell_moe_tpu_torch.ops.domains import TensorProductDomain as TDom
from cornell_moe_tpu_torch.utils import checkpoint as tck
from cornell_moe_tpu_torch.utils import real_functions as trf
from cornell_moe_tpu_torch.utils.synthetic_functions import Branin

torch.set_num_threads(1)
TOL = dict(rtol=1e-7, atol=1e-9)
VAL = dict(rtol=1e-10, atol=1e-13)
GRAD = dict(rtol=1e-9, atol=1e-12)
S, Q, M, NSTART = 4, 2, 8, 6
BOX = [[0.0, 1.0]] * 2
SGD = dict(num_multistarts=NSTART, max_num_steps=6, max_num_restarts=2,
           num_steps_averaged=3, gamma=0.7, pre_mult=1.0,
           max_relative_change=0.5)
RECOMMEND = dict(num_multistarts=1, max_num_steps=60, max_num_restarts=1,
                 num_steps_averaged=15, gamma=0.7, pre_mult=1.0,
                 max_relative_change=0.02)


def _t(a):
    return torch.as_tensor(np.array(a), dtype=torch.float64)


def _jx(fn):
    """A JAX reference computed as one jitted program."""
    return jax.jit(fn)()


def _close(got, ref, tol=TOL, err_msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               err_msg=err_msg, **tol)


def _ensembles(bucket=16, n=28, seed=0):
    r = np.random.default_rng(seed)
    x = r.random((n, 2))
    y = (np.sin(3 * x[:, 0]) + (x[:, 1] - 0.4) ** 2)[:, None]
    y = (y - y.mean()) / y.std()
    hypers = np.concatenate([0.6 + r.random((S, 1)),
                             0.2 + 0.4 * r.random((S, 2))], axis=1)
    noises = np.full((S, 1), 1e-2)
    return (jmcmc.fit_gp_ensemble("matern_2.5", jnp.asarray(hypers),
                                  jnp.asarray(noises), x, y, bucket=bucket),
            tmcmc.fit_gp_ensemble("matern_2.5", _t(hypers), _t(noises), x, y,
                                  bucket=bucket))


@pytest.fixture(scope="module")
def ens():
    return _ensembles()


@pytest.fixture(scope="module")
def member(ens):
    return jmcmc.ensemble_member(ens[0], 0), ens[1].member(0)


# ---------------------------------------------------------------------------
# EI at point lists, values and gradients, the single-GP multistart
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["analytic", "mc", "mc_being_sampled"])
def test_point_list_ei_matches_jax(member, case):
    """The closed form, and the MC estimator on the normals the JAX key
    draws (num_mc 64), with and without points being sampled."""
    j, t = member
    r = np.random.default_rng(1)
    q = 1 if case == "analytic" else 3
    pts = r.random((5, q, 2)) if q > 1 else r.random((5, 2))
    being = r.random((2, 2)) if case == "mc_being_sampled" else None
    key = jax.random.PRNGKey(4)
    ref = _jx(lambda: jei.evaluate_expected_improvement_at_point_list(
        j, pts, key=key, points_being_sampled=being, num_mc_iterations=64))
    p = 0 if being is None else 2
    normals = None if case == "analytic" else _t(jei.draw_normals(
        key, 64, q + p))
    got = tei.evaluate_expected_improvement_at_point_list(
        t, _t(pts), points_being_sampled=None if being is None else
        _t(being), num_mc_iterations=64, normals=normals)
    assert got.shape == (5,)
    _close(got, ref, VAL)


@pytest.mark.parametrize("being", [False, True])
def test_ei_value_and_grad_match_jax(member, being):
    j, t = member
    r = np.random.default_rng(2)
    pts, blocks = r.random((Q, 2)), r.random((4, Q, 2))
    bs = r.random((1, 2)) if being else None
    normals = r.standard_normal((32, Q + (1 if being else 0)))
    best = 0.1
    v_j, g_j = _jx(lambda: jei.expected_improvement_value_and_grad(
        j, pts, bs, best, jnp.asarray(normals)))
    v_t, g_t = tei.expected_improvement_value_and_grad(
        t, _t(pts), None if bs is None else _t(bs), best, _t(normals))
    _close(v_t, v_j, VAL)
    _close(g_t, g_j, GRAD)
    vb_j, gb_j = _jx(lambda: jei.expected_improvement_batch_value_and_grad(
        j, jnp.asarray(blocks), bs, best, jnp.asarray(normals)))
    vb_t, gb_t = tei.expected_improvement_batch_value_and_grad(
        t, _t(blocks), None if bs is None else _t(bs), best, _t(normals))
    _close(vb_t, vb_j, VAL)
    _close(gb_t, gb_j, GRAD)


def test_single_union_estimator_repairs_float32_variance():
    """On a near-noiseless float32 model (500 standardized Branin values,
    the hyperparameters the chain reaches there: noise 3e-6) the union
    variance's float32 error exceeds the variance: a negative diagonal in
    about half of 100 unions of 4 points.  Neither estimator repairs it,
    as in the JAX package: the single-union estimator (the VOI's) is NaN
    at the same unions as the batched one (the KG seeding's), where the
    float32 factor fails, and finite and >= 0 elsewhere."""
    f = Branin()
    box = f._search_domain
    r = np.random.default_rng(0)
    x = box[:, 0] + r.random((500, 2)) * (box[:, 1] - box[:, 0])
    y = np.array([f.evaluate_true(p)[0] for p in x])
    y = (y - y.mean()) / y.std()
    t = tmcmc.fit_gp_ensemble(
        "matern_2.5", torch.exp(torch.tensor([[0.03, 1.98, 2.78]])),
        torch.exp(torch.tensor([[-12.7]])), x, y[:, None], bucket=16
    ).member(0)
    u = torch.as_tensor(box[:, 0] + r.random((100, 4, 2)) * (
        box[:, 1] - box[:, 0]), dtype=torch.float32)
    z = torch.as_tensor(r.standard_normal((64, 4)), dtype=torch.float32)
    var = tei.gp.posterior_variance(t, u)
    assert int((torch.diagonal(var, dim1=-2, dim2=-1).min(-1).values
                < 0).sum()) > 20
    v = tei.monte_carlo_expected_improvement(t, u, None,
                                             t.best_observed_value, z)
    vb = tei.monte_carlo_expected_improvement_batch(
        t, u, t.best_observed_value, z)
    assert not bool(torch.isfinite(vb).all())
    assert torch.equal(torch.isnan(v), torch.isnan(vb))
    assert bool((v[torch.isfinite(v)] >= 0).all())


def _ei_objectives(j, t, normals):
    def vg_j(p):
        return jei.expected_improvement_value_and_grad(
            j, p, None, j.best_observed_value, jnp.asarray(normals))

    def bvg_j(p):
        return jei.expected_improvement_batch_value_and_grad(
            j, p, None, j.best_observed_value, jnp.asarray(normals))

    def vg_t(p):
        return tei.expected_improvement_value_and_grad(
            t, p, None, t.best_observed_value, _t(normals))

    def bvg_t(p):
        return tei.expected_improvement_batch_value_and_grad(
            t, p, None, t.best_observed_value, _t(normals))

    return vg_j, bvg_j, vg_t, bvg_t


@pytest.mark.parametrize("route", ["batched", "per_start", "dumb_search"])
def test_single_gp_multistart_routes_match_jax(member, route):
    """The three routes of the single-GP q-EI multistart from the same
    starts (and search blocks), then the port's entry point on each."""
    j, t = member
    r = np.random.default_rng(3)
    starts, search = r.random((NSTART, Q, 2)), r.random((5, Q, 2))
    normals = r.standard_normal((16, Q))
    vg_j, bvg_j, vg_t, bvg_t = _ei_objectives(j, t, normals)
    jd, td = JRep(domain=JDom.from_bounds(BOX), num_repeats=Q), \
        TRep(domain=TDom.from_bounds(BOX), num_repeats=Q)
    pj, pt = jopt.GradientDescentParameters(**SGD), \
        topt.GradientDescentParameters(**SGD)
    if route == "batched":
        res_j = _jx(lambda: jopt.multistart_optimize_batched(
            bvg_j, jd, jnp.asarray(starts), pj, chunk_size=3, conv_tol=3e-3))
        res_t = topt.multistart_optimize_batched(
            bvg_t, td, _t(starts), pt, chunk_size=3, conv_tol=3e-3)
        kw = {}
    elif route == "per_start":
        res_j = _jx(lambda: jopt.multistart_optimize(
            vg_j, jd, jnp.asarray(starts), pj))
        res_t = topt.multistart_optimize(vg_t, td, _t(starts), pt)
        kw = dict(use_batched=False)
    else:
        res_j = _jx(lambda: jopt.multistart_optimize_with_dumb_search_fallback(
            vg_j, jd, jnp.asarray(starts), jnp.asarray(search), pj))
        res_t = topt.multistart_optimize_with_dumb_search_fallback(
            vg_t, td, _t(starts), _t(search), pt)
        kw = dict(num_random_search=5)
    for got, ref in zip(res_t, res_j):
        _close(got, ref)
    pts = tei.multistart_expected_improvement_optimization(
        torch.Generator().manual_seed(0), t, TDom.from_bounds(BOX), Q,
        topt.GradientDescentParameters(**dict(SGD, max_num_steps=2)),
        num_mc_iterations=16, **kw)
    assert pts.shape == (Q, 2) and bool(
        TDom.from_bounds(BOX).check_point_inside(pts).all())


# ---------------------------------------------------------------------------
# heuristic q-EI
# ---------------------------------------------------------------------------

def test_estimation_policies_match_jax(member):
    j, t = member
    pt = np.array([0.4, 0.6])
    assert tei.constant_liar_estimate(t, _t(pt), -0.3, 1e-3) == \
        jei.constant_liar_estimate(j, pt, -0.3, 1e-3)
    for coef in (0.0, 1.5):
        mu_j, nv_j = _jx(lambda: jei.kriging_believer_estimate(
            j, pt, coef, 2e-3))
        mu_t, nv_t = tei.kriging_believer_estimate(t, _t(pt), coef, 2e-3)
        _close(mu_t, mu_j)
        assert nv_t == nv_j == 2e-3


HEURISTIC_Q = 3
HEURISTIC_SGD = dict(SGD, num_multistarts=4, max_num_steps=5)


@jax.jit
def _jax_round(state, starts, best):
    """One heuristic round's 1,0-EI multistart from given starts."""
    rep = JRep(domain=JDom.from_bounds(BOX), num_repeats=1)

    def bvg(p):
        return jax.vmap(jax.value_and_grad(
            lambda x: jei.analytic_expected_improvement(state, x, best)))(p)

    return jopt.multistart_optimize_batched(
        bvg, rep, starts, jopt.GradientDescentParameters(**HEURISTIC_SGD)
    ).best_point


def _torch_round(state, starts, best):
    rep = TRep(domain=TDom.from_bounds(BOX), num_repeats=1)

    def bvg(p):
        with torch.enable_grad():
            x = p.detach().requires_grad_(True)
            v = tei.analytic_expected_improvement(state, x, best)
            (g,) = torch.autograd.grad(v.sum(), x)
        return v.detach(), g

    return topt.multistart_optimize_batched(
        bvg, rep, starts, topt.GradientDescentParameters(**HEURISTIC_SGD)
    ).best_point


@pytest.mark.parametrize("policy", ["kriging_believer", "constant_liar"])
@pytest.mark.parametrize("bucket", [0, 16], ids=["plain", "bucketed"])
def test_heuristic_qei_matches_jax(monkeypatch, policy, bucket):
    """Each round's multistart runs from the same given starts in both
    packages (the packages' own draws replaced); the fantasy slots, the
    refits with the state's own point_noise (bucketed: 12 PAD_NOISE rows)
    and the estimation policy decide the picks."""
    j_ens, t_ens = _ensembles(bucket=bucket, n=20)
    j, t = jmcmc.ensemble_member(j_ens, 1), t_ens.member(1)
    assert (t.point_noise is not None) == (bucket > 0)
    starts = np.random.default_rng(5).random((HEURISTIC_Q, 4, 1, 2))
    rounds = {"jax": 0, "torch": 0}

    def jax_ms(key, state, domain, q, params, best_so_far=None,
               num_mc_iterations=None):
        i = rounds["jax"]
        rounds["jax"] += 1
        return _jax_round(state, jnp.asarray(starts[i]), best_so_far)

    def torch_ms(generator, state, domain, q, params, best_so_far=None,
                 num_mc_iterations=None, program_cache=None):
        i = rounds["torch"]
        rounds["torch"] += 1
        return _torch_round(state, _t(starts[i]), best_so_far)

    monkeypatch.setattr(jei, "multistart_expected_improvement_optimization",
                        jax_ms)
    monkeypatch.setattr(tei, "multistart_expected_improvement_optimization",
                        torch_ms)
    if policy == "kriging_believer":
        pol_j = pol_t = None
    else:
        pol_j = functools.partial(jei.constant_liar_estimate, lie_value=-0.5,
                                  lie_noise_variance=1e-3)
        pol_t = functools.partial(tei.constant_liar_estimate, lie_value=-0.5,
                                  lie_noise_variance=1e-3)
    params = dict(HEURISTIC_SGD)
    ref = jei.heuristic_expected_improvement_optimization(
        jax.random.PRNGKey(0), j, JDom.from_bounds(BOX), HEURISTIC_Q,
        jopt.GradientDescentParameters(**params), estimation_policy=pol_j)
    got = tei.heuristic_expected_improvement_optimization(
        torch.Generator().manual_seed(0), t, TDom.from_bounds(BOX),
        HEURISTIC_Q, topt.GradientDescentParameters(**params),
        estimation_policy=pol_t)
    assert rounds == {"jax": HEURISTIC_Q, "torch": HEURISTIC_Q}
    assert got.shape == (HEURISTIC_Q, 2)
    _close(got, ref)


def test_heuristic_qei_entry_point_runs(member):
    _, t = member
    dom = TDom.from_bounds(BOX)
    pts = tei.heuristic_expected_improvement_optimization(
        torch.Generator().manual_seed(0), t, dom, 2,
        topt.GradientDescentParameters(**dict(SGD, max_num_steps=2)))
    assert pts.shape == (2, 2) and bool(dom.check_point_inside(pts).all())


# ---------------------------------------------------------------------------
# the "pure" warm KG mode and the KG point list
# ---------------------------------------------------------------------------

INNER_WARM = dict(num_multistarts=1, max_num_steps=1, max_num_restarts=1,
                  num_steps_averaged=0, gamma=0.0, pre_mult=1.0,
                  max_relative_change=0.1)


def test_pure_warm_mode_matches_jax(ens):
    """KG values, union gradients and the carried endpoints at
    warm_mode="pure" (the union-point guard and its reseed candidate)."""
    j, t = ens
    r = np.random.default_rng(6)
    unions, normals = r.random((3, Q, 2)), r.standard_normal((M, Q))
    disc, x0 = r.random((S, 5, 2)), r.random((S, 3, M, 2))
    best = r.normal(-1.0, 0.1, S)
    dom = JDom.from_bounds(BOX)
    ref = _jx(lambda: jkg.knowledge_gradient_mcmc_batch_vg_carry(
        j, jnp.asarray(unions), jnp.asarray(disc), jnp.asarray(normals), dom,
        jopt.GradientDescentParameters(**INNER_WARM), jnp.asarray(best), Q,
        inner_x0=jnp.asarray(x0), warm_mode="pure"))
    got = tkg.knowledge_gradient_mcmc_batch_vg_carry(
        t, _t(unions), _t(disc), _t(normals), TDom.from_bounds(BOX),
        topt.GradientDescentParameters(**INNER_WARM), _t(best),
        inner_x0=_t(x0), warm_mode="pure")
    for name, g, rf in zip(("kg", "union_grad", "carry"), got, ref):
        _close(g, rf, err_msg=name)
    reseed = tkg.knowledge_gradient_mcmc_batch_vg_carry(
        t, _t(unions), _t(disc), _t(normals), TDom.from_bounds(BOX),
        topt.GradientDescentParameters(**INNER_WARM), _t(best),
        inner_x0=_t(x0))
    assert not torch.equal(reseed[0], got[0])


@pytest.mark.parametrize("what", ["fidelity", "derivatives"])
def test_pure_warm_mode_refuses_fidelity_and_derivatives(ens, what):
    _, t = ens
    r = np.random.default_rng(7)
    kw = {}
    if what == "derivatives":
        x = r.random((6, 2))
        y = np.stack([np.sin(x[:, 0]), np.cos(x[:, 0]), np.ones(6)], axis=1)
        t = tmcmc.fit_gp_ensemble("matern_2.5", _t([[1.0, 0.5, 0.5]]),
                                  _t([[1e-2] * 3]), x, y, (0, 1))
        unions, dom, x0 = r.random((1, Q, 2)), TDom.from_bounds(BOX), \
            r.random((1, 1, M, 2))
    else:
        unions, dom, x0 = r.random((1, Q, 2)), TDom.from_bounds(BOX[:1]), \
            r.random((S, 1, M, 1))
        kw = dict(num_fidelity=1)
    s = t.points_sampled.shape[0]
    with pytest.raises(NotImplementedError, match="pure"):
        tkg.knowledge_gradient_mcmc_batch_vg_carry(
            t, _t(unions), _t(r.random((s, 3, x0.shape[-1]))),
            _t(r.standard_normal((M, Q))), dom,
            topt.GradientDescentParameters(**INNER_WARM),
            _t(np.zeros(s)), inner_x0=_t(x0), warm_mode="pure", **kw)


def test_kg_point_list_matches_jax(ens):
    """Per-union KG at a list of blocks, per member (the port returns
    (P, S))."""
    j, t = ens
    r = np.random.default_rng(8)
    pts, normals = r.random((3, Q, 2)), r.standard_normal((M, Q))
    disc, best = r.random((S, 5, 2)), r.normal(-1.0, 0.1, S)
    inner = dict(INNER_WARM, max_num_steps=3)
    got = tkg.evaluate_knowledge_gradient_at_point_list(
        t, _t(pts), _t(disc), _t(normals), TDom.from_bounds(BOX),
        topt.GradientDescentParameters(**inner), _t(best))
    assert got.shape == (3, S)
    one = jax.jit(
        lambda s, d, b: jkg.evaluate_knowledge_gradient_at_point_list(
            s, jnp.asarray(pts), d, jnp.asarray(normals),
            JDom.from_bounds(BOX), jopt.GradientDescentParameters(**inner),
            b))
    for i in range(S):
        _close(got[:, i], one(jmcmc.ensemble_member(j, i),
                              jnp.asarray(disc[i]), best[i]))


# ---------------------------------------------------------------------------
# the whole EI slice
# ---------------------------------------------------------------------------

def test_ei_slice_matches_jax(ens):
    """Member 0's q-EI multistart from given starts and normals (gated as
    the driver gates it), the VOI on given normals, and the ensemble
    recommendation from a given grid, as the driver composes them."""
    j_ens, t_ens = ens
    j, t = jmcmc.ensemble_member(j_ens, 0), t_ens.member(0)
    r = np.random.default_rng(9)
    starts = r.random((NSTART, Q, 2))
    normals, normals_voi = r.standard_normal((32, Q)), \
        r.standard_normal((64, Q))
    grid = r.random((200, 2))
    _, bvg_j, _, bvg_t = _ei_objectives(j, t, normals)
    jd, td = JDom.from_bounds(BOX), TDom.from_bounds(BOX)

    def jax_slice():
        res = jopt.multistart_optimize_batched(
            bvg_j, JRep(domain=jd, num_repeats=Q), jnp.asarray(starts),
            jopt.GradientDescentParameters(**SGD), conv_tol=3e-3)
        voi = jei.monte_carlo_expected_improvement(
            j, res.best_point, None, j.best_observed_value,
            jnp.asarray(normals_voi))

        def neg_mean(x):
            return jnp.mean(jax.vmap(
                lambda s: jkg.posterior_mean_objective(s, x))(j_ens))

        vals = jax.vmap(neg_mean)(jnp.asarray(grid))
        vals = jnp.where(jnp.isfinite(vals), vals, -jnp.inf)
        x0 = jnp.asarray(grid)[jnp.argmax(vals)]
        x = jopt.gradient_ascent(jax.value_and_grad(neg_mean), jd, x0,
                                 jopt.GradientDescentParameters(**RECOMMEND))
        rec = jnp.where(neg_mean(x) > vals.max(), x, x0)
        return res.best_point, res.all_points, voi, rec

    res = topt.multistart_optimize_batched(
        bvg_t, TRep(domain=td, num_repeats=Q), _t(starts),
        topt.GradientDescentParameters(**SGD), conv_tol=3e-3)
    voi = tei.evaluate_expected_improvement_at_point_list(
        t, res.best_point[None], normals=_t(normals_voi))[0]
    rec = tbo.recommend_from_guesses(
        t_ens, td, _t(grid), topt.GradientDescentParameters(**RECOMMEND))
    names = ("suggested", "all_endpoints", "voi", "recommended")
    for name, got, ref in zip(names, (res.best_point, res.all_points, voi,
                                      rec), _jx(jax_slice)):
        _close(got, ref, err_msg=name)


# ---------------------------------------------------------------------------
# the driver
# ---------------------------------------------------------------------------

def _driver(**kw):
    sgd = topt.GradientDescentParameters(**dict(SGD, max_num_steps=4))
    return tbo.BayesianOptimizer(**dict(dict(
        objective_func=Branin(), method="EI", num_to_sample=2, n_hypers=4,
        noisy=True, standardize=True, burnin_steps=20, chain_length=128,
        sgd_params=sgd, num_mc=16, device="cpu", verbose=False), **kw))


def test_ei_driver_resume_equals_an_uninterrupted_run(tmp_path):
    """Two iterations in one run against one iteration, a checkpoint, a
    fresh driver that resumes, and the second iteration: the second
    iteration's suggestion, VOI, chain steps and recommendation agree bit
    for bit (the generator, the walkers and burn-in restored)."""
    whole = _driver()
    assert _driver(num_mc=None).num_mc == 2**10
    hist = whole.run(2, num_init_pts=10)
    path = str(tmp_path / "ei.ckpt")
    first = _driver(checkpoint_path=path)
    first.run(1, num_init_pts=10)
    resumed = _driver(checkpoint_path=path)
    meta = resumed.resume()
    assert meta == {"iteration": 0, "method": "EI", "capital": 0.0}
    assert resumed.model.burned and resumed.model._data.num_sampled == 12
    again = resumed.run(2, start_iteration=1)[-1]
    ref = hist[1]
    assert again["iteration"] == 1
    np.testing.assert_array_equal(again["suggested"], ref["suggested"])
    assert again["voi"] == ref["voi"] and np.isfinite(ref["voi"])
    np.testing.assert_array_equal(again["recommended"], ref["recommended"])
    assert resumed.model.last_chain_steps == whole.model.last_chain_steps
    assert torch.equal(resumed.generator.get_state(),
                       whole.generator.get_state())
    assert tck.load_checkpoint(path)[1]["metadata"]["iteration"] == 1
    box = Branin()._search_domain
    assert np.all((ref["suggested"] >= box[:, 0]) &
                  (ref["suggested"] <= box[:, 1]))
    assert [r["phase"] for r in whole.timer.records] == [
        "initialize", "suggest", "observe_retrain", "recommend",
        "suggest", "observe_retrain", "recommend"]
    assert whole.timer.records[1]["method"] == "EI"


def test_ei_driver_needs_a_card_unless_told_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tbo.BayesianOptimizer(objective_func=Branin(), method="EI")
    bo = _driver()
    assert bo.device.type == "cpu" and bo.dtype == torch.float64
    bo.save_checkpoint(0)                       # no path: nothing written


def test_sampling_helpers_run(ens):
    _, t = ens
    dom = TDom.from_bounds(BOX)
    sgd = topt.GradientDescentParameters(**dict(SGD, max_num_steps=2))
    g = torch.Generator().manual_seed(0)
    pts, voi = tbo.gen_sample_from_qei(g, t.member(0), dom, sgd, Q,
                                       num_mc=16)
    assert pts.shape == (Q, 2) and np.isfinite(voi) and voi >= 0.0
    pts, voi = tbo.gen_sample_from_qei_mcmc(g, t, dom, sgd, Q, num_mc=16)
    assert pts.shape == (Q, 2) and np.isfinite(voi) and voi >= 0.0
    disc = torch.rand((S, 4, 2), generator=g, dtype=torch.float64)
    pts, voi = tbo.gen_sample_from_qkg_mcmc(
        g, t, dom, disc, sgd, topt.GradientDescentParameters(**INNER_WARM),
        num_to_sample=Q, num_mc=8)
    assert pts.shape == (Q, 2) and np.isfinite(voi)


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------

def _cpu_sized_cifar10():
    """CIFAR10 on 40 synthetic images for one epoch, its channel widths cut
    to 2^5 (log2 units in [5, 5.4]) so that a training run takes a
    fraction of a second on the CPU."""
    f = trf.CIFAR10(epochs=1, subset=40)
    f._search_domain[2:] = [5.0, 5.4]
    return f


@pytest.fixture
def tiny_cli(monkeypatch):
    """The command line with the optimizer and the real objectives at tiny
    sizes."""
    sgd = topt.GradientDescentParameters(**dict(SGD, max_num_steps=2))
    monkeypatch.setattr(cli, "BayesianOptimizer", functools.partial(
        tbo.BayesianOptimizer, n_hypers=4, burnin_steps=20, chain_length=64,
        sgd_params=sgd, num_mc=8, verbose=False))
    monkeypatch.setitem(cli.REAL_FUNCTIONS, "KISSGP", functools.partial(
        trf.KISSGP, n_data=60, grid_size=20))
    monkeypatch.setitem(cli.REAL_FUNCTIONS, "CIFAR10", _cpu_sized_cifar10)


@pytest.mark.parametrize("args", [
    ["Branin", "EI", "2", "1", "none", "0", "1"],
    ["Branin", "KG", "2", "1", "none", "0", "1"],
    ["Hartmann6", "EI", "1", "1", "HeSBO", "2", "1"],
    ["KISSGP", "KG", "1", "1", "none", "0", "1"],
    ["CIFAR10", "EI", "1", "1", "none", "0", "1"],
    ["Branin", "KG", "2", "1", "none", "0", "1", "--devices=1"]],
    ids=["branin_ei", "branin_kg", "hartmann6_hesbo", "kissgp", "cifar10",
         "devices_1"])
def test_command_line_runs_on_the_cpu(tiny_cli, capsys, args):
    assert cli.main(["main"] + args + ["--device=cpu"]) == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert last.startswith("final best recommended value: ")
    assert np.isfinite(float(last.split()[4]))
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("args,says", [
    (["Branin", "EI", "2", "1", "--devices=2"],
     "torchrun --nproc_per_node=2"),
    (["Branin", "EI", "2", "1", "--devices", "2"], "use --devices=N"),
    (["Nowhere", "EI", "2", "1", "--device=cpu"], "unknown objective"),
    (["Branin", "EI", "2", "1", "--device", "cpu"], "requires '='")],
    ids=["devices", "devices_without_eq", "unknown", "device_without_eq"])
def test_command_line_refusals_exit_1(capsys, args, says):
    assert cli.main(["main"] + args) == 1
    assert says in capsys.readouterr().out
