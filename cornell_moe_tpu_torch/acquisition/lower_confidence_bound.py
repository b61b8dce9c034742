"""Lower-confidence-bound batch selection.

Counterpart of ``cornell_moe_tpu/acquisition/lower_confidence_bound.py``:
greedy q-point selection over a candidate set.  The first point minimizes
mu - sigma; each later point maximizes sigma among the candidates whose LCB
is below min(mu + sigma), after conditioning on the previous pick with a
zero-valued fantasy observation of noise 0.25 (pure exploration among
plausible minimizers).
"""

from __future__ import annotations

import torch

from cornell_moe_tpu_torch.models import gp as gp_mod
from cornell_moe_tpu_torch.models.gp import GaussianProcessState

_FANTASY_NOISE = 0.25


def posterior_stddev(state: GaussianProcessState, points: torch.Tensor
                     ) -> torch.Tensor:
    """Posterior standard deviation of the value at each of points (C, d),
    each point on its own: (C,)."""
    prior = state.covariance.f0(torch.zeros_like(points[..., 0]))
    va = gp_mod.solve_lower(state, gp_mod._mix_cov(state, points))
    var = prior - torch.sum(va * va, dim=-2)
    return torch.sqrt(torch.clamp(var, min=0.0))


def lower_confidence_bound_optimization(state: GaussianProcessState,
                                        candidate_pts, num_to_sample: int):
    """Pick q points of ``candidate_pts`` (C, d) for a single (not ensemble)
    state; returns ((q, d), 0.0)."""
    cand = torch.as_tensor(candidate_pts, dtype=state.points_sampled.dtype,
                           device=state.points_sampled.device
                           ).reshape(-1, state.dim)
    mu = gp_mod.posterior_mean(state, cand)[:, 0]
    sd = posterior_stddev(state, cand)
    lcb = mu - sd
    plausible = lcb <= torch.min(mu + sd)
    picks = [cand[torch.argmin(lcb)]]
    s = state
    for _ in range(1, num_to_sample):
        fantasy_value = torch.zeros((1, 1 + len(s.derivatives)),
                                    dtype=cand.dtype, device=cand.device)
        s = gp_mod.add_sampled_points(s, picks[-1][None], fantasy_value,
                                      jitter=_FANTASY_NOISE,
                                      update_mean=False)
        masked = torch.where(plausible, posterior_stddev(s, cand),
                             float("-inf"))
        picks.append(cand[torch.argmax(masked)])
    return torch.stack(picks), 0.0
