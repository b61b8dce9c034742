"""The port's main path as a whole, against the JAX package, plus the
guards around the port.

Whole-slice parity in float64 on a small problem: the same fixed
hyperparameters give the same S = 4 ensemble in both packages; then, with
the same starts, normals and discretization, the warm gated q-KG multistart
(composed as bench.py:122-149), the VOI scoring and the recommendation from
a given grid agree at rtol 1e-7 (same arithmetic; the gates see the same
step norms).
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cornell_moe_tpu import bayes_opt as jbo
from cornell_moe_tpu.acquisition import knowledge_gradient as jkg
from cornell_moe_tpu.models import mcmc as jmcmc
from cornell_moe_tpu.ops import optimizers as jopt
from cornell_moe_tpu.ops.domains import RepeatedDomain as JRep
from cornell_moe_tpu.ops.domains import TensorProductDomain as JDom
from cornell_moe_tpu_torch import bayes_opt as tbo
from cornell_moe_tpu_torch.acquisition import knowledge_gradient as tkg
from cornell_moe_tpu_torch.models import mcmc as tmcmc
from cornell_moe_tpu_torch.ops import optimizers as topt
from cornell_moe_tpu_torch.ops.domains import RepeatedDomain as TRep
from cornell_moe_tpu_torch.ops.domains import TensorProductDomain as TDom
from cornell_moe_tpu_torch.utils.synthetic_functions import Branin

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-7, atol=1e-9)
S, Q, M, NSTART = 4, 2, 8, 6
OUTER = dict(num_multistarts=NSTART, max_num_steps=8, max_num_restarts=1,
             num_steps_averaged=4, gamma=0.7, pre_mult=1.0,
             max_relative_change=0.5)
INNER_COLD = dict(num_multistarts=1, max_num_steps=6, max_num_restarts=1,
                  num_steps_averaged=3, gamma=0.0, pre_mult=1.0,
                  max_relative_change=0.1)
INNER_WARM = dict(INNER_COLD, max_num_steps=1, num_steps_averaged=0)
RECOMMEND = dict(num_multistarts=1, max_num_steps=100, max_num_restarts=1,
                 num_steps_averaged=15, gamma=0.7, pre_mult=1.0,
                 max_relative_change=0.02)


def _t(a):
    return torch.as_tensor(np.array(a), dtype=torch.float64)


@pytest.fixture
def slice_problem(rng):
    x = rng.random((28, 2))
    y = (np.sin(3 * x[:, 0]) + (x[:, 1] - 0.4) ** 2)[:, None]
    y = (y - y.mean()) / y.std()
    hypers = np.concatenate([0.6 + rng.random((S, 1)),
                             0.2 + 0.4 * rng.random((S, 2))], axis=1)
    noises = np.full((S, 1), 1e-2)
    return dict(
        j=jmcmc.fit_gp_ensemble("matern_2.5", jnp.asarray(hypers),
                                jnp.asarray(noises), x, y, bucket=16),
        t=tmcmc.fit_gp_ensemble("matern_2.5", _t(hypers), _t(noises), x, y,
                                bucket=16),
        starts=rng.random((NSTART, Q, 2)),
        normals=rng.standard_normal((M, Q)),
        normals_voi=rng.standard_normal((M, Q)),
        discrete=rng.random((S, 6, 2)),
        grid=rng.random((200, 2)))


def _jax_slice(p):
    j, dom = p["j"], JDom.from_bounds([[0.0, 1.0]] * 2)
    rep = JRep(domain=dom, num_repeats=Q)
    disc, normals = jnp.asarray(p["discrete"]), jnp.asarray(p["normals"])
    best = jbo.best_so_far_from_discretization(j, disc)
    cold = jopt.GradientDescentParameters(**INNER_COLD)
    warm = jopt.GradientDescentParameters(**INNER_WARM)

    def suggest(starts):
        def bvg_cold(u):
            return jkg.knowledge_gradient_mcmc_batch_vg_carry(
                j, u, disc, normals, dom, cold, best, Q)

        def bvg_warm(u, carry):
            return jkg.knowledge_gradient_mcmc_batch_vg_carry(
                j, u, disc, normals, dom, warm, best, Q, inner_x0=carry,
                warm_mode="reseed")

        res = jopt.multistart_optimize_batched_warm(
            bvg_cold, bvg_warm, rep, starts,
            jopt.GradientDescentParameters(**OUTER), chunk_size=3,
            conv_tol=3e-3)
        return res.best_point, res.best_value, res.all_points

    point, value, allp = jax.jit(suggest)(jnp.asarray(p["starts"]))
    voi = jax.jit(lambda u: jkg.knowledge_gradient_mcmc(
        j, u, disc, jnp.asarray(p["normals_voi"]), dom, cold, best, Q))(point)

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
    rep = TRep(domain=dom, num_repeats=Q)
    disc, normals = _t(p["discrete"]), _t(p["normals"])
    best = tbo.best_so_far_from_discretization(t, disc)
    cold = topt.GradientDescentParameters(**INNER_COLD)
    warm = topt.GradientDescentParameters(**INNER_WARM)

    def bvg_cold(u):
        return tkg.knowledge_gradient_mcmc_batch_vg_carry(
            t, u, disc, normals, dom, cold, best)

    def bvg_warm(u, carry):
        return tkg.knowledge_gradient_mcmc_batch_vg_carry(
            t, u, disc, normals, dom, warm, best, inner_x0=carry)

    res = topt.multistart_optimize_batched_warm(
        bvg_cold, bvg_warm, rep, _t(p["starts"]),
        topt.GradientDescentParameters(**OUTER), chunk_size=3,
        conv_tol=3e-3)
    voi = tkg.knowledge_gradient_mcmc(t, res.best_point, disc,
                                      _t(p["normals_voi"]), dom, cold, best)
    rec = tbo.recommend_from_guesses(
        t, dom, _t(p["grid"]), topt.GradientDescentParameters(**RECOMMEND))
    return best, res.best_point, res.best_value, res.all_points, voi, rec


def test_slice_matches_jax(slice_problem):
    names = ("best_so_far", "suggested", "kg_at_suggested", "all_endpoints",
             "voi", "recommended")
    for name, ref, got in zip(names, _jax_slice(slice_problem),
                              _torch_slice(slice_problem)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   err_msg=name, **TOL)


def test_optimizer_run_on_cpu_is_finite():
    sgd = topt.GradientDescentParameters(
        num_multistarts=6, max_num_steps=4, max_num_restarts=2,
        num_steps_averaged=2, gamma=0.7, pre_mult=1.0,
        max_relative_change=0.5)
    bo = tbo.BayesianOptimizer(
        objective_func=Branin(), method="KG", num_to_sample=2, n_hypers=4,
        noisy=True, standardize=True, burnin_steps=20, chain_length=200,
        sgd_params=sgd, num_mc=8, device="cpu", verbose=False)
    hist = bo.run(num_iterations=1, num_init_pts=10)
    rec = hist[-1]
    assert np.isfinite(rec["voi"]) and np.isfinite(rec["true_value"])
    assert rec["suggested"].shape == (2, 2)
    box = Branin()._search_domain
    assert np.all((rec["recommended"] >= box[:, 0]) &
                  (rec["recommended"] <= box[:, 1]))
    assert bo.model.last_chain_steps % 64 == 0
    assert [r["phase"] for r in bo.timer.records] == [
        "initialize", "suggest", "observe_retrain", "recommend"]


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        "import cornell_moe_tpu_torch\n"
        "from cornell_moe_tpu_torch import bayes_opt, config, convert, "
        "main\n"
        "from cornell_moe_tpu_torch.acquisition import "
        "expected_improvement, knowledge_gradient, lower_confidence_bound, "
        "pes, pes_driver\n"
        "from cornell_moe_tpu_torch.models import covariance, gp, "
        "likelihood, mcmc, priors\n"
        "from cornell_moe_tpu_torch.ops import _build, domains, kernels, "
        "linalg, optimizers, random_features\n"
        "from cornell_moe_tpu_torch.utils import checkpoint, "
        "data_containers, hesbo, logging_utils, real_functions, "
        "synthetic_functions\n"
        "from cornell_moe_tpu_torch.parallel import sharding, spawn\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'cornell_moe_tpu')]\n"
        "print(bad)\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_chip_smoke_refuses_without_a_gpu(tmp_path):
    """No CUDA device here: chip_smoke.py exits non-zero with no result,
    from the checkout and from a directory holding only the script."""
    alone = tmp_path / "chip_smoke.py"
    alone.write_text(open(os.path.join(REPO, "chip_smoke.py")).read())
    for script, cwd in ((os.path.join(REPO, "chip_smoke.py"), REPO),
                        (str(alone), str(tmp_path))):
        out = subprocess.run([sys.executable, script], cwd=cwd,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout
