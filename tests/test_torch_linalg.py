"""Parity of the port's ops/linalg.py with the JAX package's, in float64.

Tolerance: rtol 1e-9 / atol 1e-11, the JAX package's own bound for
refined-solve identities (tests/test_linalg.py:70).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cornell_moe_tpu.ops import linalg as jl
from cornell_moe_tpu_torch.ops import linalg as tl

torch.set_num_threads(1)
F64 = torch.float64
TOL = dict(rtol=1e-9, atol=1e-11)


def _spd(rng, n, batch=()):
    a = rng.standard_normal(batch + (n, n))
    return a @ np.swapaxes(a, -1, -2) + n * np.eye(n)


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=F64)


@pytest.mark.parametrize("jitter", [0.0, 1e-3])
def test_cholesky_and_logdet(rng, jitter):
    a = _spd(rng, 7, (3,))
    got = tl.cholesky(_t(a), jitter=jitter)
    ref = jl.cholesky(jnp.asarray(a), jitter=jitter)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(tl.log_det_from_chol(got).numpy(),
                               np.asarray(jl.log_det_from_chol(ref)), **TOL)


def test_cholesky_failure_is_nan():
    bad = -np.eye(3)
    assert torch.isnan(tl.cholesky(_t(bad))).all()
    assert np.isnan(np.asarray(jl.cholesky(jnp.asarray(bad)))).any()


@pytest.mark.parametrize("trans", [False, True])
def test_solve_triangular(rng, trans):
    chol = np.linalg.cholesky(_spd(rng, 6))
    rhs = rng.standard_normal((6, 4))
    got = tl.solve_triangular(_t(chol), _t(rhs), lower=True, trans=trans)
    ref = jl.solve_triangular(jnp.asarray(chol), jnp.asarray(rhs),
                              lower=True, trans=trans)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("vector", [False, True])
def test_cho_solve(rng, vector):
    chol = np.linalg.cholesky(_spd(rng, 6))
    rhs = rng.standard_normal(6 if vector else (6, 3))
    got = tl.cho_solve(_t(chol), _t(rhs))
    ref = jl.cho_solve(jnp.asarray(chol), jnp.asarray(rhs))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_refined_solves(rng):
    chol = np.linalg.cholesky(_spd(rng, 8))
    inv = np.linalg.inv(chol)
    rhs = rng.standard_normal((8, 5))
    args_t = (_t(chol), _t(inv), _t(rhs))
    args_j = (jnp.asarray(chol), jnp.asarray(inv), jnp.asarray(rhs))
    np.testing.assert_allclose(
        tl.solve_lower_with_refinement(*args_t).numpy(),
        np.asarray(jl.solve_lower_with_refinement(*args_j)), **TOL)
    np.testing.assert_allclose(
        tl.cho_solve_with_refinement(*args_t).numpy(),
        np.asarray(jl.cho_solve_with_refinement(*args_j)), **TOL)


def test_fantasy_solves_values_and_vjp(rng):
    """Values and the 2-matmul backward match the JAX custom VJP; the
    factors get no gradient."""
    chol = np.linalg.cholesky(_spd(rng, 8))
    inv = np.linalg.inv(chol)
    rhs = rng.standard_normal((8, 5))
    ct_va = rng.standard_normal((8, 5))
    ct_w = rng.standard_normal((8, 5))

    (va_j, w_j), vjp = jax.vjp(
        lambda r: jl.fantasy_solves_rhs_grad_only(
            jnp.asarray(chol), jnp.asarray(inv), r), jnp.asarray(rhs))
    (g_j,) = vjp((jnp.asarray(ct_va), jnp.asarray(ct_w)))

    chol_t = _t(chol).requires_grad_(True)
    rhs_t = _t(rhs).requires_grad_(True)
    va_t, w_t = tl.fantasy_solves_rhs_grad_only(chol_t, _t(inv), rhs_t)
    torch.autograd.backward((va_t, w_t), (_t(ct_va), _t(ct_w)))
    np.testing.assert_allclose(va_t.detach().numpy(), np.asarray(va_j), **TOL)
    np.testing.assert_allclose(w_t.detach().numpy(), np.asarray(w_j), **TOL)
    np.testing.assert_allclose(rhs_t.grad.numpy(), np.asarray(g_j), **TOL)
    assert chol_t.grad is None


def test_small_cholesky_and_solves(rng):
    a = _spd(rng, 5, (7,))
    rhs = rng.standard_normal((7, 5, 3))
    chol_t = tl.cholesky_small(_t(a))
    chol_j = jl.cholesky_small(jnp.asarray(a))
    np.testing.assert_allclose(chol_t.numpy(), np.asarray(chol_j), **TOL)
    for trans in (False, True):
        np.testing.assert_allclose(
            tl.solve_triangular_small(chol_t, _t(rhs), trans=trans).numpy(),
            np.asarray(jl.solve_triangular_small(chol_j, jnp.asarray(rhs),
                                                 trans=trans)), **TOL)
    np.testing.assert_allclose(tl.symmetrize(_t(a[0])).numpy(),
                               np.asarray(jl.symmetrize(jnp.asarray(a[0]))),
                               **TOL)
