"""Parity of the port's models/covariance.py and of the covariance kernel's
plain version (ops/kernels.covariance_with_noise) with the JAX package.

Tolerances: build_block_covariance and the scalar methods in float64 at
rtol 1e-12 (tests/test_covariance.py:35); the finite-difference ping of
``grad_covariance`` at rtol 1e-6 / atol 1e-9 (tests/test_covariance.py:55);
the kernel's plain version in float32 against the Pallas kernel in
interpret mode at rtol 2e-4 / atol 2e-5 (tests/test_pallas_kernels.py:26).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cornell_moe_tpu.models import covariance as jcov
from cornell_moe_tpu.ops import pallas_kernels as pk
from cornell_moe_tpu_torch.models import covariance as tcov
from cornell_moe_tpu_torch.ops import kernels
from cornell_moe_tpu_torch.utils import logging_utils as lu
from reference_impl import central_difference, matern52_kernel, se_kernel

torch.set_num_threads(1)
F64 = torch.float64
COVARIANCES = ["square_exponential", "matern_2.5"]


@pytest.mark.parametrize("kernel", COVARIANCES)
def test_block_covariance_matches_jax(kernel, rng):
    hypers = np.array([1.3, 0.6, 1.4])
    x1, x2 = rng.standard_normal((9, 2)), rng.standard_normal((5, 2))
    got = tcov.build_block_covariance(
        tcov.make_covariance(kernel, torch.as_tensor(hypers)),
        torch.as_tensor(x1), (), torch.as_tensor(x2), ())
    ref = jcov.build_block_covariance(jcov.make_covariance(kernel, hypers),
                                      jnp.asarray(x1), (), jnp.asarray(x2),
                                      ())
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-12)


@pytest.mark.parametrize("kernel", COVARIANCES)
def test_scalar_methods_match_jax(kernel, rng):
    """``num_hyperparameters``, ``scaled_square_dist``, ``covariance`` and
    ``grad_covariance`` (dk/dx) of an ensemble of 3 kernels, one point pair
    per kernel, against the JAX package's methods per member; coincident
    points included."""
    s, d = 3, 4
    hypers = np.concatenate([1.0 + rng.random((s, 1)),
                             0.5 + rng.random((s, d))], axis=1)
    x, y = rng.standard_normal((s, d)), rng.standard_normal((s, d))
    y[-1] = x[-1]
    cov = tcov.make_covariance(kernel, torch.as_tensor(hypers))
    assert cov.num_hyperparameters == d + 1
    for method in ("scaled_square_dist", "covariance", "grad_covariance"):
        got = getattr(cov, method)(torch.as_tensor(x), torch.as_tensor(y))
        for i in range(s):
            jc = jcov.make_covariance(kernel, hypers[i])
            assert jc.num_hyperparameters == cov.num_hyperparameters
            ref = getattr(jc, method)(jnp.asarray(x[i]), jnp.asarray(y[i]))
            np.testing.assert_allclose(got[i].numpy(), np.asarray(ref),
                                       rtol=1e-12, atol=1e-300)


@pytest.mark.parametrize("kernel", COVARIANCES)
def test_grad_covariance_ping(kernel, rng):
    """dk/dx against a central difference of the numpy kernel, and against
    autograd of ``covariance`` (tests/test_covariance.py:44-55)."""
    ref_kernel = {"square_exponential": se_kernel,
                  "matern_2.5": matern52_kernel}[kernel]
    d = 4
    hypers = np.concatenate([[1.0 + rng.random()], 0.5 + rng.random(d)])
    cov = tcov.make_covariance(kernel, torch.as_tensor(hypers))
    for _ in range(5):
        x, y = rng.standard_normal(d), rng.standard_normal(d)
        fd = central_difference(
            lambda xv: ref_kernel(hypers[0], hypers[1:], xv, y), x)
        got = cov.grad_covariance(torch.as_tensor(x), torch.as_tensor(y))
        np.testing.assert_allclose(got.numpy(), fd, rtol=1e-6, atol=1e-9)
        auto = torch.func.grad(lambda xx: cov.covariance(
            xx, torch.as_tensor(y)))(torch.as_tensor(x))
        np.testing.assert_allclose(got.numpy(), auto.numpy(), rtol=1e-12)


def test_use_pallas_switch(rng):
    """``use_pallas="never"`` gives the default's bits on the CPU (where
    "auto" takes the plain build too), and "always", which the port does
    not carry over, raises ``ValueError``, as any other value."""
    hypers = np.array([[1.3, 0.6, 1.4], [0.9, 1.1, 0.7]])
    cov = tcov.make_covariance("matern_2.5", torch.as_tensor(hypers))
    x, noise = torch.as_tensor(rng.standard_normal((7, 2))), \
        torch.full((2, 1), 1e-2, dtype=F64)
    default = tcov.build_covariance_matrix_with_noise(cov, x, (), noise)
    assert torch.equal(tcov.build_covariance_matrix_with_noise(
        cov, x, (), noise, use_pallas="never"), default)
    assert torch.equal(tcov.build_covariance_matrix_with_noise(
        cov, x, (), noise, use_pallas="auto"), default)
    for value in ("always", "sometimes"):
        with pytest.raises(ValueError):
            tcov.build_covariance_matrix_with_noise(cov, x, (), noise,
                                                    use_pallas=value)


@pytest.mark.parametrize("kernel", COVARIANCES)
def test_ensemble_covariance_with_noise_matches_jax(kernel, rng):
    """Batched hyperparameters (S, 1+d) and channel noise (S, 1) against the
    JAX package per member, with per-point noise (PAD_NOISE rows
    included)."""
    s, n = 3, 12
    hypers = np.concatenate([1.0 + rng.random((s, 1)),
                             0.4 + rng.random((s, 2))], axis=1)
    x = rng.standard_normal((n, 2))
    noise = 1e-2 + 1e-2 * rng.random((s, 1))
    point_noise = 1e-3 * rng.random((n, 1))
    point_noise[-3:] = 1e8
    got = tcov.build_covariance_matrix_with_noise(
        tcov.make_covariance(kernel, torch.as_tensor(hypers)),
        torch.as_tensor(x), (), torch.as_tensor(noise),
        torch.as_tensor(point_noise))
    for i in range(s):
        ref = jcov.build_covariance_matrix_with_noise(
            jcov.make_covariance(kernel, hypers[i]), jnp.asarray(x), (),
            jnp.asarray(point_noise + noise[i]), use_pallas="never")
        np.testing.assert_allclose(got[i].numpy(), np.asarray(ref),
                                   rtol=1e-12)


@pytest.mark.parametrize("kernel", COVARIANCES)
def test_covariance_kernel_plain_matches_pallas(kernel, rng):
    """The kernel's plain version (float32, CPU) vs the Pallas kernel in
    interpret mode, per-point PAD_NOISE rows included."""
    n, d, s = 40, 3, 2
    hypers = np.concatenate([1.2 + rng.random((s, 1)),
                             0.5 + rng.random((s, d))], axis=1
                            ).astype(np.float32)
    x = rng.standard_normal((n, d)).astype(np.float32)
    noise = (1e-3 + rng.random((s, n))).astype(np.float32)
    noise[:, -8:] = 1e8
    got = kernels.covariance_with_noise(
        torch.as_tensor(x), torch.as_tensor(hypers), torch.as_tensor(noise),
        kernel)
    for i in range(s):
        ref = pk.pallas_covariance_with_noise_full(
            jnp.asarray(x), jnp.asarray(hypers[i]), jnp.asarray(noise[i]),
            kernel, interpret=True)
        np.testing.assert_allclose(got[i].numpy(), np.asarray(ref),
                                   rtol=2e-4, atol=2e-5)
    assert float(got[0, -1, -1]) > 1e7


def test_cpu_wrappers_take_the_plain_path(rng):
    """CPU tensors go to the plain versions and launch nothing."""
    before = lu.counters()
    x = torch.as_tensor(rng.random((10, 2)), dtype=torch.float32)
    h = torch.tensor([[1.0, 0.5, 0.5]])
    nz = torch.full((1, 10), 1e-2)
    kernels.covariance_with_noise(x, h, nz)
    us = (x.T / 0.5)[None].contiguous()
    kernels.lml_fused(us, torch.ones(1), nz, torch.ones(1, 10), 10)
    s, b, d, m, q = 1, 2, 2, 4, 1
    desc = (torch.rand(s, b, d, m), us,
            torch.rand(s, b, (1 + q) * (1 + d), 10), torch.rand(s, b, q, m),
            torch.rand(q, m), torch.rand(s, b, q, d))
    for run in (kernels.descent_run, kernels.descent_run_fma):
        run(*desc, torch.tensor([[[0.0, 0.0], [1.0, 1.0], [1.0, 1.0]]]),
            "matern_2.5", steps=2, restarts=1, avg_n=1, gamma=0.0,
            pre_mult=1.0, mrc=0.1)
    for grad in (kernels.descent_grad, kernels.descent_grad_fma):
        grad(*desc, "matern_2.5")
    kernels.lml_chol_f64(torch.eye(10, dtype=torch.float64)[None],
                         torch.ones(10, dtype=torch.float64))
    assert lu.growth(before) == {}


def test_wrapper_refuses_grad_inputs():
    h = torch.tensor([[1.0, 0.5, 0.5]], requires_grad=True)
    with pytest.raises(RuntimeError, match="requires grad"):
        kernels.covariance_with_noise(torch.zeros(4, 2), h,
                                      torch.zeros(1, 4))
