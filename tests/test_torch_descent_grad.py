"""The per-step KG inner-descent route of the port (kernel D,
``kernels.descent_grad``, through ``_descent_grad_bvg`` and
``optimizers.gradient_ascent_batch``) against the JAX package's
``_pallas_descent_bvg`` and ``_pallas_descent_full`` in interpret mode.

On the CPU the wrapper takes its plain version.  The problem is
tests/test_pallas_descent.py:22-37 (n = 37, d = 2, B = 3, q = 4, M = 16,
float32); the JAX states are carried across with ``convert.py``.

Tolerances (float32 on both sides, sums in other orders): the direction to
2e-5 max(max|g|, 1) (tests/test_pallas_descent.py:48); a 4-member ensemble
in one stacked call against the port's per-member loop at 1e-5
(benchmarks/check_pallas_descent.py:55-66, the same arithmetic) and against
the JAX per-member loop at 1e-5 max(max|g|, 1); the route's endpoints at
atol 5e-5 (tests/test_pallas_descent.py:64-65).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cornell_moe_tpu.acquisition import knowledge_gradient as jkg
from cornell_moe_tpu.models import gp as jgp
from cornell_moe_tpu.models import mcmc as jmcmc
from cornell_moe_tpu.models.covariance import COVARIANCE_TYPES as JCOV
from cornell_moe_tpu.ops import optimizers as jopt
from cornell_moe_tpu.ops.domains import TensorProductDomain as JDom
from cornell_moe_tpu_torch import convert
from cornell_moe_tpu_torch.acquisition import knowledge_gradient as tkg
from cornell_moe_tpu_torch.ops import kernels
from cornell_moe_tpu_torch.ops import optimizers as topt
from cornell_moe_tpu_torch.ops.domains import TensorProductDomain as TDom
from cornell_moe_tpu_torch.utils import logging_utils as lu
from test_torch_descent_mma import _emulated_descent_grad

torch.set_num_threads(1)
COVARIANCES = ["matern_2.5", "square_exponential"]
N, D, B, Q, M = 37, 2, 3, 4, 16
ROUTE = dict(num_multistarts=1, max_num_steps=6, max_num_restarts=2,
             num_steps_averaged=3, gamma=0.3, pre_mult=1.0,
             max_relative_change=0.1)


def _f(a):
    return torch.as_tensor(np.array(a), dtype=torch.float32)


def _port_state(jstate, kernel, stacked):
    """The port's float32 ensemble state from a JAX state (a single state
    becomes a one-member ensemble)."""
    def member_axis(a):
        a = np.asarray(a)
        return a if stacked else a[None]

    arrays = {"hyperparameters": jstate.covariance.hyperparameters,
              **{k: getattr(jstate, k) for k in convert.GP_STATE_FIELDS[1:]}}
    return convert.gp_state_from_arrays(
        {k: None if a is None else member_axis(a) for k, a in arrays.items()},
        kernel, dtype=torch.float32)


def _problem(rng, kernel):
    """tests/test_pallas_descent.py:22-37, under either covariance."""
    f32 = np.float32
    x = rng.random((N, D)).astype(f32)
    y = np.sin(3 * x[:, 0]) + x[:, 1]
    jstate = jgp.fit_gp(
        JCOV[kernel](hyperparameters=jnp.asarray([1.3, 0.4, 0.5], f32)),
        jnp.asarray([1e-2], f32), jnp.asarray(x),
        jnp.asarray(y, f32)[:, None])
    return dict(j=jstate, t=_port_state(jstate, kernel, stacked=False),
                x=x, y=y.astype(f32),
                unions=rng.random((B, Q, D)).astype(f32),
                v=(rng.standard_normal((B, N, Q)) * 0.1).astype(f32),
                betas=rng.standard_normal((B, M, Q)).astype(f32),
                normals=rng.standard_normal((M, Q)).astype(f32),
                pts=rng.random((B, M, D)).astype(f32))


def _jax_args(p):
    return tuple(jnp.asarray(p[k]) for k in ("unions", "v", "betas",
                                             "normals"))


def _port_bvg(p, state, s, kernel):
    return tkg._descent_grad_bvg(
        state, _f(p["unions"]), _f(p["v"]).expand(s, B, N, Q),
        _f(p["betas"]).expand(s, B, M, Q), _f(p["normals"]), kernel)


@pytest.mark.parametrize("kernel", COVARIANCES)
@pytest.mark.parametrize("contraction", ["plain", "mma_emulated"])
def test_descent_grad_bvg_matches_pallas(monkeypatch, rng, kernel,
                                         contraction):
    """mma_emulated: the moment contraction as kernel D's tensor-core
    instance forms it (3xTF32 products, summed per 8-point k-tile and
    accumulated in float32; its field is exact, where the kernel's takes
    rsqrt.approx and ex2.approx), emulated in float32 by
    tests/test_torch_descent_mma.py."""
    if contraction == "mma_emulated":
        monkeypatch.setattr(kernels, "descent_grad_plain",
                            _emulated_descent_grad)
    p = _problem(rng, kernel)
    _, g_j = jkg._pallas_descent_bvg(p["j"], *_jax_args(p), kernel,
                                     interpret=True)(jnp.asarray(p["pts"]))
    vals, g_t = _port_bvg(p, p["t"], 1, kernel)(_f(p["pts"])[None])
    ref = float(jnp.max(jnp.abs(g_j)))
    assert g_t.shape == (1, B, M, D) and not bool(vals.any())
    assert float(np.max(np.abs(g_t[0].numpy() - np.asarray(g_j)))) < \
        2e-5 * max(ref, 1.0)


def test_descent_grad_ensemble_matches_pallas_loop(rng):
    """Four members in one stacked call against the per-member loop: the
    port's own at 1e-5 (check_pallas_descent.py:66, the same arithmetic),
    the JAX package's at 1e-5 max(max|g|, 1) (float32 sums in other
    orders; one entry of 96 is 1.2e-5 apart at |g| = 1.4)."""
    p = _problem(rng, "matern_2.5")
    hypers = (np.abs(rng.standard_normal((4, 1 + D))) + 0.5).astype(
        np.float32)
    jstates = jmcmc.fit_gp_ensemble(
        "matern_2.5", jnp.asarray(hypers), jnp.full((4, 1), 1e-2,
                                                    jnp.float32),
        jnp.asarray(p["x"]), jnp.asarray(p["y"])[:, None])
    tstates = _port_state(jstates, "matern_2.5", stacked=True)
    _, g_t = _port_bvg(p, tstates, 4, "matern_2.5")(
        _f(p["pts"]).expand(4, B, M, D))
    for i in range(4):
        member = jmcmc.ensemble_member(jstates, i)
        _, g_j = jkg._pallas_descent_bvg(
            member, *_jax_args(p), "matern_2.5",
            interpret=True)(jnp.asarray(p["pts"]))
        _, g_i = _port_bvg(p, _port_state(member, "matern_2.5", False), 1,
                           "matern_2.5")(_f(p["pts"])[None])
        np.testing.assert_allclose(g_t[i].numpy(), g_i[0].numpy(),
                                   rtol=0.0, atol=1e-5)
        bound = 1e-5 * max(float(jnp.max(jnp.abs(g_j))), 1.0)
        np.testing.assert_allclose(g_t[i].numpy(), np.asarray(g_j),
                                   rtol=0.0, atol=bound)


@pytest.mark.parametrize("kernel", COVARIANCES)
def test_descent_grad_route_matches_fused_descent(rng, kernel):
    """gradient_ascent_batch over the port's bvg ends where the port's
    whole-descent kernel route and the JAX fused descent end."""
    p = _problem(rng, kernel)
    tdom = TDom.from_bounds([[0.0, 1.0]] * D, dtype=torch.float32)
    params = topt.GradientDescentParameters(**ROUTE)
    x0 = _f(p["pts"])[None]
    route = topt.gradient_ascent_batch(_port_bvg(p, p["t"], 1, kernel),
                                       tdom, x0, params)
    fused = tkg._descent_full(p["t"], _f(p["unions"]), _f(p["v"])[None],
                              _f(p["betas"])[None], _f(p["normals"]), x0,
                              tdom, params, kernel)
    ref = jkg._pallas_descent_full(
        p["j"], *_jax_args(p), jnp.asarray(p["pts"]),
        JDom(bounds=jnp.asarray([[0.0, 1.0]] * D, jnp.float32)),
        jopt.GradientDescentParameters(**ROUTE), kernel, interpret=True)
    np.testing.assert_allclose(route[0].numpy(), fused[0].numpy(), atol=5e-5)
    np.testing.assert_allclose(route[0].numpy(), np.asarray(ref), atol=5e-5)


def _operands(rng, s=2, b=3, d=2, q=4, m=16, np_=37):
    return [_f(a) for a in (
        rng.random((s, b, d, m)), rng.random((s, d, np_)),
        0.3 * rng.standard_normal((s, b, (1 + q) * (1 + d), np_)),
        rng.standard_normal((s, b, q, m)), rng.standard_normal((q, m)),
        rng.random((s, b, q, d)))]


def test_cpu_wrapper_takes_the_plain_version(rng):
    args = _operands(rng)
    before = lu.counters()
    got = kernels.descent_grad(*args, "square_exponential")
    assert torch.equal(got, kernels.descent_grad_plain(
        *args, "square_exponential"))
    assert lu.growth(before) == {}


def test_wrapper_refuses_grad_and_unknown_fields(rng):
    args = _operands(rng)
    with pytest.raises(RuntimeError):
        kernels.descent_grad(args[0].clone().requires_grad_(), *args[1:],
                             "matern_2.5")
    with pytest.raises(ValueError):
        kernels.descent_grad(*args, "matern_1.5")
