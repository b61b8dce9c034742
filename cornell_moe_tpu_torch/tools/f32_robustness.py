"""The float32 robustness grid: float32 fits against float64 fits of the
same data, where single precision breaks.

Counterpart of ``tests/test_f32_robustness.py``: the same cases (tight
length scales, near-duplicate inputs, n = 2000), the same data generator
and the same bounds, for standardized data (unit-variance values, unit-box
inputs, noise floor 1e-2).  Three quantities per case:

- the float32 posterior mean and variance at 64 points against float64's;
- the fantasy model's diagonal repair (the shift above the channel noise
  inside its Cholesky, ``knowledge_gradient._build_fantasy_model_batch``)
  at 16 unions of q = 4;
- the batched KG estimator (``knowledge_gradient_batch``) in float32
  against float64 at 8 unions of q = 2.

Each function takes numpy inputs, runs on ``device`` in ``dtype`` and
returns float64 numpy, so the CPU tests (float32 on the CPU, the JAX
package's float64 as the oracle of the port's) and ``chip_smoke.py``
(float32 against float64 on the card) share them.
"""

from __future__ import annotations

import numpy as np
import torch

from cornell_moe_tpu_torch.acquisition import knowledge_gradient as kg_mod
from cornell_moe_tpu_torch.models import covariance as cov_mod
from cornell_moe_tpu_torch.models import gp as gp_mod
from cornell_moe_tpu_torch.ops import optimizers
from cornell_moe_tpu_torch.ops.domains import TensorProductDomain

NOISE_FLOOR = 1e-2   # the float32 noise floor of standardized data

# (n, length scale, near-duplicate fraction)
CASES = [
    (200, 0.05, 0.0),     # tight length scale
    (200, 0.3, 0.1),      # near-duplicate points
    (500, 0.1, 0.05),     # both, at the main path's size
    (2000, 0.2, 0.02),    # large n
]

# bounds of float32 against float64 (tests/test_f32_robustness.py)
MEAN_BOUND = 0.3 * NOISE_FLOOR
VARIANCE_BOUND = 0.5 * NOISE_FLOOR
REPAIR_BOUND = 0.1 * NOISE_FLOOR
KG_RELATIVE, KG_ABSOLUTE = 0.05, 1e-4

# the KG case: n 500, near-duplicate fraction 0.05, length scale 0.2
KG_CASE = (500, 0.2, 0.05)
KG_INNER = optimizers.GradientDescentParameters(
    num_multistarts=1, max_num_steps=6, max_num_restarts=1,
    num_steps_averaged=3, gamma=0.0, pre_mult=1.0, max_relative_change=0.1)


def make_data(rng: np.random.Generator, n: int, near_dup_frac: float = 0.0):
    """Standardized synthetic data on the unit box; optionally a fraction
    of near-duplicate points (1e-5 apart), adversarial for the kernel
    matrix's conditioning."""
    x = rng.random((n, 2))
    if near_dup_frac > 0:
        k = int(n * near_dup_frac)
        x[-k:] = x[:k] + 1e-5 * rng.standard_normal((k, 2))
        x = np.clip(x, 0.0, 1.0)
    y = np.sin(6 * x[:, 0]) + np.cos(4 * x[:, 1])
    y = (y - y.mean()) / y.std()
    return x, y


def fit(x, y, lengths: float, dtype, device, noise: float = NOISE_FLOOR
        ) -> gp_mod.GaussianProcessState:
    """One Matern 5/2 GP (amplitude 1, both length scales ``lengths``)."""
    kw = dict(dtype=dtype, device=device)
    cov = cov_mod.MaternNu2p5(
        hyperparameters=torch.tensor([1.0, lengths, lengths], **kw))
    return gp_mod.fit_gp(cov, torch.tensor([noise], **kw),
                         torch.as_tensor(x, **kw),
                         torch.as_tensor(y, **kw)[:, None])


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float64).numpy()


def posterior(x, y, lengths: float, points, dtype, device):
    """(mean (P,), variance (P,), whether the Cholesky is finite) of the
    fit at ``points`` (P, 2)."""
    state = fit(x, y, lengths, dtype, device)
    pts = torch.as_tensor(points, dtype=dtype, device=device)
    mu = gp_mod.posterior_mean(state, pts)[:, 0]
    var = torch.diagonal(gp_mod.posterior_variance(state, pts))
    return _numpy(mu), _numpy(var), bool(torch.isfinite(state.chol_K).all())


def fantasy_repair(x, y, lengths: float, unions, dtype, device):
    """(the fantasy model's largest diagonal shift above the noise floor,
    whether its Cholesky factors are finite) at ``unions`` (B, q, 2)."""
    state = fit(x, y, lengths, dtype, device).as_ensemble()
    _, chol_u, _, noise_eff = kg_mod._build_fantasy_model_batch(
        state, torch.as_tensor(unions, dtype=dtype, device=device))
    return float(torch.max(noise_eff)) - NOISE_FLOOR, \
        bool(torch.isfinite(chol_u).all())


def kg_values(x, y, discrete, unions, normals, dtype, device) -> np.ndarray:
    """The batched KG estimator at ``unions`` (B, q, 2) with the inner
    descent seeded at ``discrete`` (n_d, 2) on ``normals`` (M, q), best so
    far the least observed value: (B,)."""
    kw = dict(dtype=dtype, device=device)
    state = fit(x, y, KG_CASE[1], dtype, device).as_ensemble()
    dom = TensorProductDomain(bounds=torch.tensor([[0.0, 1.0], [0.0, 1.0]],
                                                  **kw))
    kg = kg_mod.knowledge_gradient_batch(
        state, torch.as_tensor(unions, **kw),
        torch.as_tensor(discrete, **kw)[None],
        torch.as_tensor(normals, **kw), dom, KG_INNER,
        torch.tensor([float(y.min())], **kw))
    return _numpy(kg[0])


def kg_bound(kg64: np.ndarray) -> float:
    """The largest |KG32 - KG64| the reference allows: 5% of the float64
    values' scale (at least 1e-3) plus 1e-4."""
    scale = max(float(np.max(np.abs(kg64))), 1e-3)
    return KG_RELATIVE * scale + KG_ABSOLUTE
