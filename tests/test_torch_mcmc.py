"""Parity of the port's priors, LML, fused-LML plain version and MCMC
sampler with the JAX package.

Tolerances: priors and the plain LML in float64 at rtol 1e-10
(tests/test_likelihood_mcmc.py:32); the fused-LML kernel's plain version in
float32 at rtol 5e-4 against the Pallas kernel in interpret mode at
Np = 128 and 768 (tests/test_pallas_descent.py:168-171) and against JAX's
vmapped LML at Np = 384, where the Pallas kernel cannot trace; the model
log-posterior at 1e-4 (tests/test_pallas_descent.py:203-204); a stretch
move fed JAX's random numbers bit for bit.  The sampler's statistics
(``run_ensemble_mcmc(keep_chain=True)`` from a seeded ``torch.Generator``)
at the bounds of the JAX package's own statistical tests
(tests/test_likelihood_mcmc.py:138, 292 and 371): a known Gaussian, a 1-d
GP posterior known by quadrature, and an independent numpy stretch move on
a 3-d GP posterior.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cornell_moe_tpu.models import covariance as jcov
from cornell_moe_tpu.models import likelihood as jlik
from cornell_moe_tpu.models import mcmc as jmcmc
from cornell_moe_tpu.models import priors as jpriors
from cornell_moe_tpu.ops import pallas_kernels as pk
from cornell_moe_tpu.utils.data_containers import HistoricalData as JHist
from cornell_moe_tpu_torch import convert
from cornell_moe_tpu_torch.models import covariance as tcov
from cornell_moe_tpu_torch.models import likelihood as tlik
from cornell_moe_tpu_torch.models import mcmc as tmcmc
from cornell_moe_tpu_torch.models import priors as tpriors
from cornell_moe_tpu_torch.ops import kernels
from cornell_moe_tpu_torch.utils.data_containers import HistoricalData

torch.set_num_threads(1)
F64 = torch.float64


def _t(a, dtype=F64):
    return torch.as_tensor(np.array(a), dtype=dtype)


def test_default_prior_matches_jax(rng):
    thetas = rng.standard_normal((6, 4)) * 2.0
    thetas[0, 1] = 3.5                      # outside the length tophat
    jp = jpriors.DefaultPrior(n_dims=4, num_noise=1)
    tp = tpriors.DefaultPrior(n_dims=4, num_noise=1)
    ref = np.array([float(jp.lnprob(jnp.asarray(t))) for t in thetas])
    np.testing.assert_allclose(tp.lnprob(_t(thetas)).numpy(), ref,
                               rtol=1e-10)
    g = torch.Generator().manual_seed(0)
    draws = tp.sample_from_prior(g, 2000)
    assert draws.shape == (2000, 4)
    assert abs(float(draws[:, 0].mean())) < 0.1          # Normal(0, 1)
    assert float(draws[:, 1:3].min()) >= -2.0 and \
        float(draws[:, 1:3].max()) <= 3.0                # Tophat(-2, 3)


def test_plain_lml_matches_jax(rng):
    x = rng.random((12, 2))
    y = np.sin(3 * x[:, 0])
    pn = np.zeros((12, 1))
    pn[-3:] = 1e8
    hypers = np.array([[1.2, 0.3, 0.5], [0.7, 0.6, 0.2]])
    got = tlik.log_marginal_likelihood(
        tcov.make_covariance("matern_2.5", _t(hypers)), _t([[1e-2], [3e-2]]),
        _t(x), _t(y), point_noise=_t(pn))
    for i, nv in enumerate((1e-2, 3e-2)):
        ref = jlik.log_marginal_likelihood(
            jcov.make_covariance("matern_2.5", hypers[i]), jnp.asarray([nv]),
            jnp.asarray(x), jnp.asarray(y), point_noise=jnp.asarray(pn))
        np.testing.assert_allclose(float(got[i]), float(ref), rtol=1e-10)


def _lml_inputs(rng, w, n, np_):
    """Padded walker batch as tests/test_pallas_descent.py builds it."""
    x = rng.random((n, 2)).astype(np.float32)
    lengths = (0.3 + 0.4 * rng.random((w, 2))).astype(np.float32)
    alphas = (0.8 + rng.random(w)).astype(np.float32)
    noises = (1e-2 + 1e-2 * rng.random(w)).astype(np.float32)
    y = np.sin(3 * x[:, 0]).astype(np.float32)
    us = np.zeros((w, 2, np_), np.float32)
    noise_vec = np.zeros((w, np_), np.float32)
    y_pad = np.zeros((w, np_), np.float32)
    for i in range(w):
        us[i, :, :n] = (x / lengths[i]).T
        us[i, :, n:] = 1e6 * (np.arange(np_ - n) + 1)[None, :]
        noise_vec[i, :n] = noises[i]
        noise_vec[i, n:] = 1e8
        y_pad[i, :n] = y
    return x, lengths, alphas, noises, y, us, noise_vec, y_pad


@pytest.mark.parametrize("np_", [128, 384])
def test_lml_kernel_plain_matches_jax(rng, np_):
    """Np = 128: against the Pallas kernel in interpret mode.  Np = 384
    (the Pallas kernel cannot trace there): against JAX's vmapped LML."""
    w, n = 8, 37 if np_ == 128 else 300
    x, lengths, alphas, noises, y, us, noise_vec, y_pad = _lml_inputs(
        rng, w, n, np_)
    f32 = torch.float32
    quad, logdet = kernels.lml_fused(_t(us, f32), _t(alphas, f32),
                                     _t(noise_vec, f32), _t(y_pad, f32), n)
    if np_ == 128:
        ref_q, ref_l = pk.pallas_lml_fused(
            jnp.asarray(us), jnp.asarray(alphas), jnp.asarray(noise_vec),
            jnp.asarray(y_pad), "matern_2.5", n_real=n, wb=4,
            interpret=True)
        np.testing.assert_allclose(quad.numpy(), np.asarray(ref_q),
                                   rtol=5e-4)
        np.testing.assert_allclose(logdet.numpy(), np.asarray(ref_l),
                                   rtol=5e-4)
        return
    # the padded walker system's LML: the real rows only (the padding
    # columns sit at huge distinct offsets and carry huge noise)
    lml = -0.5 * quad - logdet - 0.5 * n * math.log(2.0 * math.pi)

    def one(h, nv):
        return jlik.log_marginal_likelihood(
            jcov.MaternNu2p5(hyperparameters=h), nv, jnp.asarray(x),
            jnp.asarray(y))

    hyp = np.concatenate([alphas[:, None], lengths], axis=1).astype(float)
    ref = jax.vmap(one)(jnp.asarray(hyp), jnp.asarray(noises[:, None],
                                                      float))
    np.testing.assert_allclose(lml.numpy(), np.asarray(ref), rtol=5e-4)


def test_lml_kernel_plain_matches_interpret_at_768(rng):
    """Np = 768, the largest size at which the JAX package runs all three
    of its kernels (a multiple of 256, where its kernel B traces): the
    port's plain version, which kernel B's large-Np instance is held to on
    the card, against the Pallas kernel in interpret mode at W 2, d 2,
    rtol 5e-4 as at Np = 128."""
    w, n, np_ = 2, 760, 768
    _, _, alphas, _, _, us, noise_vec, y_pad = _lml_inputs(rng, w, n, np_)
    f32 = torch.float32
    assert kernels.lml_fused_instance(np_) == "global"
    quad, logdet = kernels.lml_fused(_t(us, f32), _t(alphas, f32),
                                     _t(noise_vec, f32), _t(y_pad, f32), n)
    ref_q, ref_l = pk.pallas_lml_fused(
        jnp.asarray(us), jnp.asarray(alphas), jnp.asarray(noise_vec),
        jnp.asarray(y_pad), "matern_2.5", n_real=n, wb=2, interpret=True)
    np.testing.assert_allclose(quad.numpy(), np.asarray(ref_q), rtol=5e-4)
    np.testing.assert_allclose(logdet.numpy(), np.asarray(ref_l), rtol=5e-4)


def _jax_stretch_draws(key, half):
    """JAX's random numbers of one stretch_move_step, in its key order."""
    draws = []
    for k in jax.random.split(key):
        kz, kc, ku = jax.random.split(k, 3)
        draws.append(tuple(torch.as_tensor(np.array(a)) for a in (
            jax.random.uniform(kz, (half,), dtype=jnp.float64),
            jax.random.randint(kc, (half,), 0, half),
            jax.random.uniform(ku, (half,), dtype=jnp.float64))))
    return draws


def test_stretch_move_with_jax_draws_matches_exactly(rng):
    w, d = 8, 3
    pos = rng.standard_normal((w, d))
    prec = np.diag([1.0, 4.0, 0.25])

    def lp_j(p):
        return -0.5 * jnp.einsum("wi,ij,wj->w", p, jnp.asarray(prec), p)

    def lp_t(p):
        return -0.5 * torch.einsum("wi,ij,wj->w", p, _t(prec), p)

    key = jax.random.PRNGKey(3)
    for _ in range(3):
        key, sub = jax.random.split(key)
        jp, jl = jmcmc.stretch_move_step(sub, jnp.asarray(pos),
                                         lp_j(jnp.asarray(pos)), lp_j)
        tp, tl = tmcmc.stretch_move_step_with_draws(
            _t(pos), lp_t(_t(pos)), lp_t, _jax_stretch_draws(sub, w // 2))
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
        pos = np.asarray(jp)


def _models(rng, n=21):
    x = rng.random((n, 2))
    y = np.sin(3 * x[:, 0])
    jdata, tdata = JHist(dim=2), HistoricalData(dim=2)
    jdata.append_historical_data(x, y)
    tdata.append_historical_data(x, y)
    jm = jmcmc.GaussianProcessLogLikelihoodMCMC(
        jdata, noisy=True, bucket=8, rng_key=jax.random.PRNGKey(0),
        standardize=True)
    tm = tmcmc.GaussianProcessLogLikelihoodMCMC(
        tdata, noisy=True, bucket=8, standardize=True, device="cpu",
        dtype=F64, generator=torch.Generator().manual_seed(0))
    return jm, tm


def test_log_posterior_matches_jax(rng):
    jm, tm = _models(rng)
    thetas = 0.5 * rng.standard_normal((8, 4))
    thetas[0, 0] = 25.0                     # out of bounds -> -inf
    xp, yp, pn = jm._padded_data()
    ref = np.asarray(jm._log_posterior_with_data()(jnp.asarray(thetas), xp,
                                                   yp, pn))
    got = tm.log_posterior(_t(thetas), *tm._padded_data()).numpy()
    assert np.isneginf(ref[0]) and np.isneginf(got[0])
    np.testing.assert_allclose(got[1:], ref[1:], rtol=1e-4)


@pytest.mark.parametrize("derivatives", [(), (0, 1)])
def test_derivatives_property_matches_jax(rng, derivatives):
    """``derivatives``, read-only, and the noise channels it sets, as the
    JAX package's model's."""
    x = rng.random((6, 2))
    models = []
    for pkg, hist in ((jmcmc, JHist), (tmcmc, HistoricalData)):
        data = hist(dim=2, num_derivatives=len(derivatives))
        data.append_historical_data(
            x, rng.standard_normal((6, 1 + len(derivatives))))
        kw = dict(rng_key=jax.random.PRNGKey(0)) if pkg is jmcmc else \
            dict(device="cpu", dtype=F64)
        models.append(pkg.GaussianProcessLogLikelihoodMCMC(
            data, derivatives=list(derivatives), **kw))
    jm, tm = models
    assert tm.derivatives == jm.derivatives == derivatives
    assert tm.num_noise == 1 + len(derivatives)
    with pytest.raises(AttributeError):
        tm.derivatives = ()


def test_gated_chain_step_counts(rng):
    """Multiples of the 64-step segment; the two-lag drift needs 3
    segments, so at least 192 steps; the cap rounds up."""
    _, tm = _models(rng)
    x, y, pn = tm._padded_data()
    g = torch.Generator().manual_seed(1)
    p0 = tm.prior.sample_from_prior(g, 16, dtype=F64).clamp(-19.9, 19.9)

    def lp(t):
        return tm.log_posterior(t, x, y, pn)

    _, _, steps = tmcmc.run_ensemble_mcmc_gated(g, lp, p0, 400, rel_tol=50.0)
    assert steps % 64 == 0 and steps == 192
    _, _, steps = tmcmc.run_ensemble_mcmc_gated(g, lp, p0, 100,
                                                rel_tol=1e-12)
    assert steps == 128


def test_train_and_walker_transfer(rng):
    """A short train gives a finite 16-member ensemble; the JAX model's
    walkers carried over by convert.set_mcmc_walkers continue the chain."""
    jm, tm = _models(rng)
    tm.burnin_steps, tm.chain_length, tm.chain_gate_tol = 10, 300, 1.0
    jm.burnin_steps, jm.chain_length = 10, 20
    jm.train()
    convert.set_mcmc_walkers(tm, np.asarray(jm.p0), jm.hypers)
    tm._finalize_models()
    np.testing.assert_allclose(tm.models.chol_K.numpy(),
                               np.asarray(jm.models.chol_K), rtol=1e-9,
                               atol=1e-10)
    tm.train()
    assert tm.burned and tm.last_chain_steps in (192, 256, 320)
    assert torch.isfinite(tm.models.chol_K).all()
    assert tm.models.chol_K.shape == (16, 24, 24)


# ---------------------------------------------------------------------------
# sampler statistics (run_ensemble_mcmc(keep_chain=True))
# ---------------------------------------------------------------------------

def test_keep_chain_takes_the_segment_chains_steps(rng):
    """``keep_chain`` runs step by step even when a ``segment_fn`` is given
    (a segment hands back its last positions only): the same steps, bit for
    bit, as the segment chain, its last row the final positions."""
    mean = _t([1.0, -2.0])

    def log_prob(theta):
        return -0.5 * torch.sum((theta - mean) ** 2, dim=-1)

    def segment_fn(pos, lp, u, idx, acc):
        return tmcmc.chain_segment(log_prob, pos, lp, u, idx, acc)

    p0 = _t(rng.standard_normal((8, 2)))
    pos_s, lp_s = tmcmc.run_ensemble_mcmc(
        torch.Generator().manual_seed(5), log_prob, p0, 70,
        segment_fn=segment_fn)
    for seg in (None, segment_fn):
        pos, lp, chain = tmcmc.run_ensemble_mcmc(
            torch.Generator().manual_seed(5), log_prob, p0, 70,
            segment_fn=seg, keep_chain=True)
        assert chain.shape == (70, 8, 2)
        assert torch.equal(pos, pos_s) and torch.equal(lp, lp_s)
        assert torch.equal(chain[-1], pos)


def test_stretch_move_sampler_recovers_gaussian():
    """The moments of a known 2-d Gaussian (tests/test_likelihood_mcmc.py:
    138): 32 walkers, 1500 steps, the first 500 dropped; mean within 0.1,
    covariance within 0.25."""
    mean = _t([1.0, -2.0])
    cov = np.array([[1.0, 0.6], [0.6, 2.0]])
    cov_inv = _t(np.linalg.inv(cov))

    def log_prob(theta):
        d = theta - mean
        return -0.5 * torch.einsum("wi,ij,wj->w", d, cov_inv, d)

    g = torch.Generator().manual_seed(3)
    p0 = torch.randn((32, 2), generator=g, dtype=F64)
    _, _, chain = tmcmc.run_ensemble_mcmc(
        torch.Generator().manual_seed(4), log_prob, p0, 1500,
        keep_chain=True)
    samples = chain[500:].reshape(-1, 2).numpy()
    np.testing.assert_allclose(samples.mean(0), [1.0, -2.0], atol=0.1)
    np.testing.assert_allclose(np.cov(samples.T), cov, atol=0.25)


def test_sampler_statistics_match_quadrature(rng):
    """Posterior moments of a real 1-d GP-LML target against quadrature
    (tests/test_likelihood_mcmc.py:292): K(theta) = e^theta C for a fixed
    C, under a N(0, 1) prior, through the port's own LML; 10 walkers, 400
    burn-in steps, 4000 kept; mean within 0.12 and std within 0.15 of the
    exact std."""
    n = 30
    x = rng.uniform(-2, 2, (n, 1))
    d2 = (x[:, None, 0] - x[None, :, 0]) ** 2
    c = np.exp(-0.5 * d2 / 0.7**2) + 0.1 * np.eye(n)
    y = np.linalg.cholesky(c) @ rng.standard_normal(n) * 1.3
    s = float(y @ np.linalg.solve(c, y))

    tg = np.linspace(-6.0, 6.0, 20001)
    logp = -0.5 * s * np.exp(-tg) - 0.5 * n * tg - 0.5 * tg**2
    p = np.exp(logp - logp.max())
    p /= np.trapezoid(p, tg)
    mean_q = np.trapezoid(tg * p, tg)
    std_q = np.sqrt(np.trapezoid((tg - mean_q) ** 2 * p, tg))

    xt, yt = _t(x), _t(y[:, None])

    def log_prob(thetas):
        th = thetas[:, 0]
        cov = tcov.SquareExponential(hyperparameters=torch.stack(
            [torch.exp(th), torch.full_like(th, 0.7)], dim=-1))
        lml = tlik.log_marginal_likelihood(cov, 0.1 * torch.exp(th)[:, None],
                                           xt, yt)
        return lml - 0.5 * th**2

    p0 = _t(rng.standard_normal((10, 1)))
    pos, _ = tmcmc.run_ensemble_mcmc(torch.Generator().manual_seed(3),
                                     log_prob, p0, 400)
    _, _, chain = tmcmc.run_ensemble_mcmc(
        torch.Generator().manual_seed(4), log_prob, pos, 4000,
        keep_chain=True)
    samples = chain.reshape(-1).numpy()
    mean_c, std_c = samples.mean(), samples.std()
    assert abs(mean_c - mean_q) < 0.12 * std_q, (mean_c, mean_q, std_q)
    assert abs(std_c - std_q) < 0.15 * std_q, (std_c, std_q)


def test_sampler_statistics_match_numpy_reference(rng):
    """The port's chain against the JAX package's independent numpy
    stretch move (tests/test_likelihood_mcmc.py:371) on the real 3-d GP
    log-posterior (log amplitude, log length, log noise) under a N(0, 1.5)
    prior, both through the port's LML: 12 walkers, 600 burn-in steps,
    4000 kept; each coordinate's mean within 0.2 and std within 0.25 of
    the reference's std."""
    from test_likelihood_mcmc import _data, _numpy_stretch_move

    x, y = _data(rng, n=25, dim=1)
    xt, yt = _t(x), _t(y[:, None])
    prior = tpriors.NormalPrior(mean=0.0, sigma=1.5)

    def log_prob(thetas):
        cov = tcov.SquareExponential(hyperparameters=torch.exp(thetas[:, :2]))
        val = tlik.log_marginal_likelihood(
            cov, torch.exp(thetas[:, 2:3]), xt, yt) + prior.lnprob(thetas)
        return torch.where(torch.isfinite(val), val, float("-inf"))

    def log_prob_np(thetas):
        return log_prob(_t(thetas)).numpy()

    walkers, burn, steps = 12, 600, 4000
    p0 = 0.5 * rng.standard_normal((walkers, 3))
    pos, _ = tmcmc.run_ensemble_mcmc(torch.Generator().manual_seed(11),
                                     log_prob, _t(p0), burn)
    _, _, chain = tmcmc.run_ensemble_mcmc(
        torch.Generator().manual_seed(12), log_prob, pos, steps,
        keep_chain=True)
    dev = chain.reshape(-1, 3).numpy()

    ref_rng = np.random.default_rng(7)
    pos_np = _numpy_stretch_move(ref_rng, log_prob_np, p0.copy(), burn)
    ref = _numpy_stretch_move(ref_rng, log_prob_np, pos_np[-1], steps)
    ref = ref.reshape(-1, 3)
    for k in range(3):
        sd = ref[:, k].std()
        assert abs(dev[:, k].mean() - ref[:, k].mean()) < 0.2 * sd, k
        assert abs(dev[:, k].std() - sd) < 0.25 * sd, k
