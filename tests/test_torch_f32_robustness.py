"""The port's float32 robustness sweep: counterpart of
``tests/test_f32_robustness.py``.

The same cases, data generator and bounds (``tools/f32_robustness.py``):
the port's float32 fits on the CPU against its own float64 fits, where
single precision breaks (tight length scales, near-duplicate inputs,
n = 2000).  The port's float64 is held to the JAX package's float64 on the
same numpy inputs at rtol 1e-10 (the KG estimator at the same 1e-10 of
its largest value), the JAX side jitted.  The reference marks all three
slow; here none is: with the JAX oracle jitted, each case, n = 2000
included, takes about a second or two on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cornell_moe_tpu.acquisition import knowledge_gradient as jkg
from cornell_moe_tpu.acquisition.expected_improvement import \
    draw_antithetic_normals
from cornell_moe_tpu.models import covariance as jcov
from cornell_moe_tpu.models import gp as jgp
from cornell_moe_tpu.ops import optimizers as jopt
from cornell_moe_tpu.ops.domains import TensorProductDomain as JDom
from cornell_moe_tpu_torch.tools import f32_robustness as f32

PARITY = dict(rtol=1e-10, atol=0.0)

def _jax_fit(x, y, lengths):
    cov = jcov.MaternNu2p5(jnp.stack([1.0, lengths, lengths]))
    return jgp.fit_gp(cov, jnp.asarray([f32.NOISE_FLOOR]), x, y[:, None])


@jax.jit
def _jax_posterior(x, y, lengths, pts):
    s = _jax_fit(x, y, lengths)
    return jgp.posterior_mean(s, pts)[:, 0], \
        jnp.diagonal(jgp.posterior_variance(s, pts))


@jax.jit
def _jax_noise_eff(x, y, lengths, unions):
    return jkg._build_fantasy_model_batch(_jax_fit(x, y, lengths), unions,
                                          ())[3]


_JAX_INNER = jopt.GradientDescentParameters(**vars(f32.KG_INNER))


@jax.jit
def _jax_kg(x, y, unions, discrete, normals):
    return jkg.knowledge_gradient_batch(
        _jax_fit(x, y, f32.KG_CASE[1]), unions, discrete, normals,
        JDom(bounds=jnp.asarray([[0.0, 1.0], [0.0, 1.0]])), _JAX_INNER,
        jnp.min(y))


@pytest.mark.parametrize("n,ls,dup", f32.CASES)
def test_f32_posterior_matches_f64_oracle(rng, n, ls, dup):
    """tests/test_f32_robustness.py:66: the float32 posterior mean and
    variance at 64 random points within 0.3 and 0.5 of the noise floor of
    float64's; the port's float64 equal to the JAX package's."""
    x, y = f32.make_data(rng, n, dup)
    pts = rng.random((64, 2))
    mu32, var32, finite = f32.posterior(x, y, ls, pts, torch.float32, "cpu")
    mu64, var64, _ = f32.posterior(x, y, ls, pts, torch.float64, "cpu")
    assert finite, f"f32 Cholesky non-finite at n={n} ls={ls} dup={dup}"
    ref_mu, ref_var = _jax_posterior(jnp.asarray(x), jnp.asarray(y), ls,
                                     jnp.asarray(pts))
    np.testing.assert_allclose(mu64, np.asarray(ref_mu), **PARITY)
    np.testing.assert_allclose(var64, np.asarray(ref_var), **PARITY)
    assert np.max(np.abs(mu32 - mu64)) < f32.MEAN_BOUND, \
        (n, ls, dup, float(np.max(np.abs(mu32 - mu64))))
    assert np.max(np.abs(var32 - var64)) < f32.VARIANCE_BOUND, \
        (n, ls, dup, float(np.max(np.abs(var32 - var64))))


@pytest.mark.parametrize("n,ls,dup", f32.CASES)
def test_f32_fantasy_repair_stays_bounded(rng, n, ls, dup):
    """tests/test_f32_robustness.py:93: the float32 fantasy model's
    diagonal repair under 10 pct of the noise floor at 16 unions of q = 4,
    its Cholesky finite; in float64 the port's shift equals the JAX
    package's (the noise floor: no repair)."""
    x, y = f32.make_data(rng, n, dup)
    unions = rng.random((16, 4, 2))
    repair, finite = f32.fantasy_repair(x, y, ls, unions, torch.float32,
                                        "cpu")
    assert finite, f"fantasy Cholesky non-finite at n={n} ls={ls} dup={dup}"
    assert repair < f32.REPAIR_BOUND, \
        f"f32 diag repair {repair:.2e} exceeds bound at n={n} ls={ls} " \
        f"dup={dup}"
    repair64, _ = f32.fantasy_repair(x, y, ls, unions, torch.float64, "cpu")
    noise_eff = _jax_noise_eff(jnp.asarray(x), jnp.asarray(y), ls,
                               jnp.asarray(unions))
    np.testing.assert_allclose(repair64 + f32.NOISE_FLOOR,
                               float(jnp.max(noise_eff)), **PARITY)


def test_f32_kg_estimator_tracks_f64(rng):
    """tests/test_f32_robustness.py:113: the batched KG estimator in
    float32 at the bench shape (n 500) within 5 pct of float64's scale
    plus 1e-4, on the JAX package's antithetic normals; the port's float64
    equal to the JAX package's."""
    n, _, dup = f32.KG_CASE
    x, y = f32.make_data(rng, n, dup)
    discrete = rng.random((7, 2))
    unions = rng.random((8, 2, 2))
    normals = np.array(draw_antithetic_normals(jax.random.PRNGKey(3), 64,
                                               2))
    vals = {dt: f32.kg_values(x, y, discrete, unions, normals, dt, "cpu")
            for dt in (torch.float32, torch.float64)}
    ref = np.asarray(_jax_kg(jnp.asarray(x), jnp.asarray(y),
                             jnp.asarray(unions), jnp.asarray(discrete),
                             jnp.asarray(normals)))
    np.testing.assert_allclose(vals[torch.float64], ref, rtol=1e-10,
                               atol=1e-10 * np.max(np.abs(ref)))
    dev = np.max(np.abs(vals[torch.float32] - vals[torch.float64]))
    assert dev < f32.kg_bound(vals[torch.float64]), \
        (dev, f32.kg_bound(vals[torch.float64]))
