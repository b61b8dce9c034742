"""Parity of the port's ops/linalg.py with the JAX package's, in float64.

Tolerance: rtol 1e-9 / atol 1e-11, the JAX package's own bound for
refined-solve identities (tests/test_linalg.py:70).  The bfloat16 fantasy
solve (``inv_chol_lowp``) runs in float32: against the JAX package's at
``LOWP_TOL`` (1e-4) of each output's scale, and against the exact float32
solve at the JAX package's own bounds (tests/test_linalg.py:139-175: va
3e-4, w and the gradient 2e-2).  Both packages multiply the same bfloat16
operands exactly and sum in float32, each in its own order; where the two
float32 residuals (or va) straddle a bfloat16 rounding boundary, their
bfloat16 copies differ by one unit in the last place (2^-8) of the
correction, about 2^-16 of va times the conditioning of L: on these
well-conditioned systems (K = A A^T + n I) up to 1e-5 of the scale,
measured at n 24 to 200, so 1e-4 holds with room.
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
LOWP_TOL = 1e-4


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


def _spd_system_f32(rng, n=40, rhs_cols=7):
    """tests/test_linalg.py's system (K = A A^T + n I), in float32."""
    a = rng.standard_normal((n, n))
    chol = np.linalg.cholesky(a @ a.T + n * np.eye(n))
    inv = np.linalg.inv(chol)
    rhs = rng.standard_normal((n, rhs_cols))
    return tuple(x.astype(np.float32) for x in (chol, inv, rhs))


def _lowp_pair_torch(chol, inv, rhs, ct_va, ct_w):
    rhs_t = torch.as_tensor(rhs).requires_grad_(True)
    inv_t = torch.as_tensor(inv)
    va, w = tl.fantasy_solves_rhs_grad_only(
        torch.as_tensor(chol), inv_t, rhs_t,
        inv_chol_lowp=inv_t.to(torch.bfloat16))
    torch.autograd.backward((va, w), (torch.as_tensor(ct_va),
                                      torch.as_tensor(ct_w)))
    return va.detach().numpy(), w.detach().numpy(), rhs_t.grad.numpy()


def _close_to_scale(got, ref, frac, name):
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=frac * float(np.max(np.abs(ref))),
                               err_msg=name)


@pytest.mark.parametrize("batch", [(), (3,)])
def test_fantasy_solves_lowp_matches_jax(rng, batch):
    """va, w and the VJP of the bfloat16 chain against JAX's
    ``fantasy_solves_rhs_grad_only(..., inv_chol_lowp=inv_chol.astype(
    jnp.bfloat16))``; every output is float32."""
    systems = [_spd_system_f32(rng, n=24, rhs_cols=5)
               for _ in range(int(np.prod(batch)))]
    chol, inv, rhs = (np.stack(a).reshape(batch + a[0].shape)
                      for a in zip(*systems))
    ct_va = rng.standard_normal(rhs.shape).astype(np.float32)
    ct_w = rng.standard_normal(rhs.shape).astype(np.float32)

    def pair(r):
        return jl.fantasy_solves_rhs_grad_only(
            jnp.asarray(chol), jnp.asarray(inv), r,
            inv_chol_lowp=jnp.asarray(inv).astype(jnp.bfloat16))

    (va_j, w_j), vjp = jax.vjp(pair, jnp.asarray(rhs))
    (g_j,) = vjp((jnp.asarray(ct_va), jnp.asarray(ct_w)))
    got = _lowp_pair_torch(chol, inv, rhs, ct_va, ct_w)
    for name, g, r in zip(("va", "w", "rhs_grad"), got, (va_j, w_j, g_j)):
        assert g.dtype == np.float32 and np.asarray(r).dtype == np.float32
        _close_to_scale(g, np.asarray(r), LOWP_TOL, name)


def test_fantasy_solves_lowp_within_the_jax_bounds(rng):
    """The port's own contract, tests/test_linalg.py:139-175: the bfloat16
    chain's va within 3e-4 of the exact float32 solve's scale, w and the
    gradient of sum(sin va) + sum(cos w) within 2e-2."""
    chol, inv, rhs = _spd_system_f32(rng)

    def grad(lowp):
        rhs_t = torch.as_tensor(rhs).requires_grad_(True)
        inv_t = torch.as_tensor(inv)
        va, w = tl.fantasy_solves_rhs_grad_only(
            torch.as_tensor(chol), inv_t, rhs_t,
            inv_chol_lowp=inv_t.to(torch.bfloat16) if lowp else None)
        (torch.sum(torch.sin(va)) + torch.sum(torch.cos(w))).backward()
        return va.detach().numpy(), w.detach().numpy(), rhs_t.grad.numpy()

    va_lp, w_lp, g_lp = grad(True)
    va_ex, w_ex, g_ex = grad(False)
    _close_to_scale(va_lp, va_ex, 3e-4, "va")
    _close_to_scale(w_lp, w_ex, 2e-2, "w")
    _close_to_scale(g_lp, g_ex, 2e-2, "rhs_grad")
    assert not np.array_equal(va_lp, va_ex)


def test_fantasy_solves_lowp_gives_the_factors_no_gradient(rng):
    chol, inv, rhs = _spd_system_f32(rng, n=12, rhs_cols=3)
    chol_t = torch.as_tensor(chol).requires_grad_(True)
    lowp = torch.as_tensor(inv).to(torch.bfloat16).requires_grad_(True)
    rhs_t = torch.as_tensor(rhs).requires_grad_(True)
    va, w = tl.fantasy_solves_rhs_grad_only(
        chol_t, torch.as_tensor(inv), rhs_t, inv_chol_lowp=lowp)
    (va.sum() + w.sum()).backward()
    assert chol_t.grad is None and lowp.grad is None
    assert rhs_t.grad is not None and bool(torch.isfinite(rhs_t.grad).all())
