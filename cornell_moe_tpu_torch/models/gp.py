"""Gaussian-process posterior core over value and derivative channels.

Counterpart of ``cornell_moe_tpu/models/gp.py``.  The fitted GP is a
dataclass of tensors; an ensemble of S fitted GPs is the same dataclass
with a leading axis S on every tensor (the covariance's hyperparameters
are (S, 1 + d)).  Every posterior function below broadcasts over that axis,
where the JAX package vmaps.

Each sampled point carries ``1 + m`` observation channels (the value and
the partial derivatives listed in ``derivatives``), so the training system
has N = n (1 + m) rows, point-major.  The prior mean is the empirical mean
of the value channel, subtracted from value channels only.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from cornell_moe_tpu_torch.models import covariance as cov_mod
from cornell_moe_tpu_torch.models.covariance import StationaryCovariance
from cornell_moe_tpu_torch.ops import linalg


@dataclasses.dataclass
class GaussianProcessState:
    """Fitted-GP state; optional leading ensemble axis on every tensor."""

    covariance: StationaryCovariance
    noise_variance: torch.Tensor        # (..., 1 + m) per-channel noise
    points_sampled: torch.Tensor        # (..., n, dim)
    points_sampled_value: torch.Tensor  # (..., n, 1 + m)
    chol_K: torch.Tensor                # (..., N, N) lower factor
    K_inv_y: torch.Tensor               # (..., N)
    mean: torch.Tensor                  # (...,) prior mean
    inv_chol_K: Optional[torch.Tensor] = None    # (..., N, N) L^-1
    point_noise: Optional[torch.Tensor] = None   # (..., n, 1 + m)
    derivatives: Tuple[int, ...] = ()   # observed partials, m of them

    @property
    def dim(self) -> int:
        return self.points_sampled.shape[-1]

    @property
    def num_sampled(self) -> int:
        return self.points_sampled.shape[-2]

    @property
    def num_derivatives(self) -> int:
        return len(self.derivatives)

    @property
    def best_observed_value(self) -> torch.Tensor:
        return torch.min(self.points_sampled_value[..., 0], dim=-1).values

    @property
    def best_observed_point(self) -> torch.Tensor:
        """The sampled point of the least observed value, (..., dim)."""
        idx = torch.argmin(self.points_sampled_value[..., 0], dim=-1)
        return torch.take_along_dim(self.points_sampled,
                                    idx[..., None, None], dim=-2)[..., 0, :]

    def member(self, i: int) -> "GaussianProcessState":
        """Member ``i`` of an ensemble state (leading axis dropped)."""
        def take(t):
            return None if t is None else t[i]
        return dataclasses.replace(
            self, covariance=type(self.covariance)(
                hyperparameters=self.covariance.hyperparameters[i]),
            noise_variance=self.noise_variance[i],
            points_sampled=self.points_sampled[i],
            points_sampled_value=self.points_sampled_value[i],
            chol_K=self.chol_K[i], K_inv_y=self.K_inv_y[i],
            mean=self.mean[i], inv_chol_K=take(self.inv_chol_K),
            point_noise=take(self.point_noise))

    def as_ensemble(self) -> "GaussianProcessState":
        """One GP as an ensemble of one member (a leading axis of 1 on
        every tensor): the inverse of ``member(0)``."""
        def lift(t):
            return None if t is None else t[None]
        return dataclasses.replace(
            self, covariance=type(self.covariance)(
                hyperparameters=self.covariance.hyperparameters[None]),
            noise_variance=self.noise_variance[None],
            points_sampled=self.points_sampled[None],
            points_sampled_value=self.points_sampled_value[None],
            chol_K=self.chol_K[None], K_inv_y=self.K_inv_y[None],
            mean=self.mean[None], inv_chol_K=lift(self.inv_chol_K),
            point_noise=lift(self.point_noise))


STATE_TENSORS = ("noise_variance", "points_sampled", "points_sampled_value",
                 "chol_K", "K_inv_y", "mean", "inv_chol_K", "point_noise")


# the state fields the posterior mean reads: the inputs of a program that
# evaluates it (the recommendation's, the seeding's polish)
MEAN_FIELDS = ("points_sampled", "K_inv_y", "mean")


def state_tensors(state: GaussianProcessState,
                  fields: Sequence[str] = STATE_TENSORS):
    """The state's tensors as a flat list, for a program's inputs, and
    their layout: per field of ``fields`` (after the covariance's
    hyperparameters) None when absent, "expanded" for a tensor expanded
    over the leading axis (the list holds its member 0, the shared data),
    else "dense".  :func:`state_from_tensors` inverts it (the fields left
    out are None); the layout is hashable, for a program's key."""
    tensors, layout = [state.covariance.hyperparameters], []
    for name in fields:
        t = getattr(state, name)
        if t is None:
            layout.append(None)
        elif t.dim() > 0 and t.shape[0] > 1 and t.stride(0) == 0:
            layout.append("expanded")
            tensors.append(t[0])
        else:
            layout.append("dense")
            tensors.append(t)
    return tensors, (type(state.covariance), tuple(fields), tuple(layout),
                     state.derivatives)


def state_from_tensors(layout, tensors) -> GaussianProcessState:
    """The state of :func:`state_tensors`' list and layout, each expanded
    field expanded again over the hyperparameters' batch axes."""
    cov_type, fields, how_each, ds = layout
    hypers, rest = tensors[0], list(tensors[1:])
    batch = hypers.shape[:-1]
    kw = dict.fromkeys(STATE_TENSORS)
    for name, how in zip(fields, how_each):
        if how is None:
            kw[name] = None
            continue
        t = rest.pop(0)
        kw[name] = t.expand(batch + t.shape) if how == "expanded" else t
    return GaussianProcessState(covariance=cov_type(hyperparameters=hypers),
                                derivatives=ds, **kw)


def fit_gp(covariance: StationaryCovariance, noise_variance,
           points_sampled, points_sampled_value, derivatives=(),
           jitter=0.0, mean=None, precompute_inverse: bool = True,
           point_noise=None) -> GaussianProcessState:
    """Build the derived GP state (RecomputeDerivedVariables counterpart).

    The covariance's hyperparameters may carry batch axes (...): the
    result is then an ensemble state over them, with ``noise_variance``
    (..., 1 + m), one entry per channel, and ``jitter`` a float or a (...)
    tensor.  ``points_sampled`` (n, dim) and ``points_sampled_value``
    (n, 1 + m) are shared; ``point_noise`` (n, 1 + m) is added per point on
    top of the channel noise (the shape-bucketing mechanism).  ``mean``
    defaults to the empirical mean of the value channel.
    """
    fit = fit_inputs(covariance, noise_variance, points_sampled,
                     points_sampled_value, derivatives, point_noise)
    factors = fit_factors(covariance, *fit, jitter=jitter, mean=mean,
                          precompute_inverse=precompute_inverse)
    return assemble_state(covariance, *fit, *factors)


def fit_inputs(covariance: StationaryCovariance, noise_variance,
               points_sampled, points_sampled_value, derivatives=(),
               point_noise=None):
    """:func:`fit_gp`'s inputs as tensors of the points' dtype and device,
    checked: (noise (..., 1 + m), x (n, dim), y (n, 1 + m), point_noise
    (n, 1 + m) or None, derivatives)."""
    ds = cov_mod.channels(derivatives)
    c = 1 + len(ds)
    x = torch.as_tensor(points_sampled)
    kw = dict(dtype=x.dtype, device=x.device)
    y = torch.as_tensor(points_sampled_value, **kw)
    if y.dim() == 1:
        y = y[:, None]
    batch = covariance.hyperparameters.shape[:-1]
    noise = torch.as_tensor(noise_variance, **kw)
    if noise.numel() == c:
        noise = noise.reshape(c).expand(batch + (c,))
    elif noise.numel() == c * batch.numel():
        noise = noise.reshape(batch + (c,))
    else:
        raise ValueError(
            f"noise_variance of shape {tuple(noise.shape)}: expected {c} "
            "channels (value + derivative observations) per member")
    if covariance.dim != x.shape[-1]:
        raise ValueError(
            f"covariance has {covariance.dim} length scales but points "
            f"have dim {x.shape[-1]}")
    if y.shape[-1] != c:
        raise ValueError(f"values have {y.shape[-1]} channels, expected {c}")
    if point_noise is not None:
        point_noise = torch.as_tensor(point_noise, **kw).reshape(
            x.shape[0], c)
    return noise, x, y, point_noise, ds


def fit_factors(covariance: StationaryCovariance, noise, x, y, point_noise,
                ds, jitter=0.0, mean=None, precompute_inverse: bool = True):
    """The device part of :func:`fit_gp` on :func:`fit_inputs`' tensors:
    (chol_K, K_inv_y, inv_chol_K or None, mean (0-d)).  No host read: the
    ensemble fit's program (``models.mcmc.fit_gp_ensemble``) captures it."""
    kw = dict(dtype=x.dtype, device=x.device)
    batch = covariance.hyperparameters.shape[:-1]
    n, c = x.shape[0], 1 + len(ds)
    k = cov_mod.build_covariance_matrix_with_noise(covariance, x, ds, noise,
                                                   point_noise)
    chol = linalg.cholesky(k, jitter=jitter)

    if mean is None:
        mean = torch.mean(y[:, 0])
    mean = torch.as_tensor(mean, **kw)
    y_centered = torch.cat([y[:, :1] - mean, y[:, 1:]], dim=1).reshape(-1)
    k_inv_y = linalg.cho_solve(chol, y_centered.expand(batch + (n * c,)))
    inv_chol = linalg.solve_triangular(
        chol, torch.eye(n * c, **kw).expand_as(chol),
        lower=True) if precompute_inverse else None
    return chol, k_inv_y, inv_chol, mean


def assemble_state(covariance: StationaryCovariance, noise, x, y,
                   point_noise, ds, chol, k_inv_y, inv_chol, mean
                   ) -> GaussianProcessState:
    """The state of :func:`fit_inputs`' tensors and :func:`fit_factors`'
    results, the shared data expanded over the batch axes."""
    batch = covariance.hyperparameters.shape[:-1]

    def per_member(t):
        return t.expand(batch + t.shape)

    return GaussianProcessState(
        covariance=covariance, noise_variance=noise,
        points_sampled=per_member(x), points_sampled_value=per_member(y),
        chol_K=chol, K_inv_y=k_inv_y, mean=mean.expand(batch),
        inv_chol_K=inv_chol,
        point_noise=None if point_noise is None else per_member(point_noise),
        derivatives=ds)


def _mix_cov(state: GaussianProcessState, points_to_sample: torch.Tensor,
             derivatives_to_sample: Sequence[int] = ()) -> torch.Tensor:
    """K(X_train, X_star) over channels: (..., N, q (1 + ms))."""
    return cov_mod.build_block_covariance(
        state.covariance, state.points_sampled, state.derivatives,
        points_to_sample, derivatives_to_sample)


def posterior_mean(state: GaussianProcessState, points_to_sample,
                   derivatives_to_sample: Sequence[int] = ()
                   ) -> torch.Tensor:
    """Posterior mean at points (..., q, d) over the value and the requested
    derivative channels: (..., q, 1 + ms); the prior mean is added to the
    value channel only."""
    c = 1 + len(cov_mod.channels(derivatives_to_sample))
    kt = _mix_cov(state, points_to_sample, derivatives_to_sample)
    mu = (kt.transpose(-1, -2) @ state.K_inv_y[..., None])[..., 0]
    mu = mu.reshape(mu.shape[:-1] + (-1, c))
    return torch.cat([mu[..., :1] + state.mean[..., None, None], mu[..., 1:]],
                     dim=-1)


def solve_lower(state: GaussianProcessState, rhs: torch.Tensor
                ) -> torch.Tensor:
    """L^-1 rhs for the state's factor L: the refined inverse-Cholesky
    matmul when the state carries L^-1, else a triangular solve."""
    if state.inv_chol_K is not None:
        return linalg.solve_lower_with_refinement(state.chol_K,
                                                  state.inv_chol_K, rhs)
    return linalg.solve_triangular(state.chol_K, rhs, lower=True)


def posterior_covariance(state: GaussianProcessState, points_1,
                         points_2=None,
                         derivatives_to_sample: Sequence[int] = ()
                         ) -> torch.Tensor:
    """K(A,B) - K(A,X) K^-1 K(X,B) over channel blocks, refined
    inverse-Cholesky path when the state carries L^-1."""
    ds = cov_mod.channels(derivatives_to_sample)
    b = points_1 if points_2 is None else points_2
    prior = cov_mod.build_block_covariance(state.covariance, points_1, ds,
                                           b, ds)
    ka = _mix_cov(state, points_1, ds)
    kb = ka if points_2 is None else _mix_cov(state, b, ds)
    va = solve_lower(state, ka)
    vb = va if points_2 is None else solve_lower(state, kb)
    return prior - va.transpose(-1, -2) @ vb


def posterior_variance(state: GaussianProcessState, points_to_sample,
                       derivatives_to_sample: Sequence[int] = ()
                       ) -> torch.Tensor:
    """Joint posterior covariance over points_to_sample's channels."""
    return posterior_covariance(state, points_to_sample, None,
                                derivatives_to_sample)


def posterior_cholesky_variance(state: GaussianProcessState,
                                points_to_sample,
                                derivatives_to_sample: Sequence[int] = (),
                                jitter: float = 0.0) -> torch.Tensor:
    """Lower Cholesky factor of the posterior variance (NaN on failure)."""
    var = posterior_variance(state, points_to_sample, derivatives_to_sample)
    return linalg.cholesky(var, jitter=jitter)


def _jacobian(fn, points_to_sample: torch.Tensor) -> torch.Tensor:
    """d fn / d points by reverse-mode autograd (``torch.func.jacrev``):
    fn's output axes, then the points' (q, dim)."""
    return torch.func.jacrev(fn)(points_to_sample)


def grad_posterior_mean(state: GaussianProcessState, points_to_sample,
                        derivatives_to_sample: Sequence[int] = ()
                        ) -> torch.Tensor:
    """d mean / d points for one GP: (q, 1 + ms, q, dim); the diagonal
    blocks ``out[i, :, i, :]`` are the per-point gradients."""
    return _jacobian(lambda p: posterior_mean(state, p,
                                              derivatives_to_sample),
                     points_to_sample)


def grad_posterior_variance(state: GaussianProcessState, points_to_sample,
                            derivatives_to_sample: Sequence[int] = ()
                            ) -> torch.Tensor:
    """d Var / d points for one GP: (N, N, q, dim), N = q (1 + ms)."""
    return _jacobian(lambda p: posterior_variance(state, p,
                                                  derivatives_to_sample),
                     points_to_sample)


def grad_posterior_cholesky_variance(
        state: GaussianProcessState, points_to_sample,
        derivatives_to_sample: Sequence[int] = (),
        jitter: float = 0.0) -> torch.Tensor:
    """d chol(Var) / d points for one GP: (N, N, q, dim), through the
    Cholesky's own derivative."""
    return _jacobian(lambda p: posterior_cholesky_variance(
        state, p, derivatives_to_sample, jitter=jitter), points_to_sample)


def add_sampled_points(state: GaussianProcessState, new_points,
                       new_values, jitter: float = 0.0,
                       update_mean: bool = True) -> GaussianProcessState:
    """A new state conditioned on additional observations ``new_points``
    (q, d) with values (q, 1 + m), shared by every member.

    The factor grows by the block-Cholesky append
    (:func:`linalg.chol_update_append`) instead of a refactorization; the
    new points' block carries the channel noise plus ``jitter``.  K^-1 y,
    L^-1 (when the state carries it) and the per-point noise (zero rows)
    are refreshed; the prior mean is re-estimated when ``update_mean``.
    """
    kw = dict(dtype=state.points_sampled.dtype,
              device=state.points_sampled.device)
    xp = torch.as_tensor(new_points, **kw).reshape(-1, state.dim)
    yp = torch.as_tensor(new_values, **kw).reshape(xp.shape[0], -1)
    batch = state.points_sampled.shape[:-2]

    cross = _mix_cov(state, xp, state.derivatives)
    new_block = cov_mod.build_covariance_matrix_with_noise(
        state.covariance, xp, state.derivatives, state.noise_variance)
    if jitter:
        new_block = linalg.add_jitter(new_block, jitter)
    chol = linalg.chol_update_append(state.chol_K, cross, new_block)

    x = torch.cat([state.points_sampled, xp.expand(batch + xp.shape)], dim=-2)
    y = torch.cat([state.points_sampled_value, yp.expand(batch + yp.shape)],
                  dim=-2)
    mean = torch.mean(y[..., 0], dim=-1) if update_mean else state.mean
    y_centered = torch.cat([y[..., :1] - mean[..., None, None], y[..., 1:]],
                           dim=-1).reshape(batch + (-1,))
    inv_chol = None if state.inv_chol_K is None else linalg.solve_triangular(
        chol, torch.eye(chol.shape[-1], **kw).expand_as(chol), lower=True)
    pn = None if state.point_noise is None else torch.cat(
        [state.point_noise, torch.zeros_like(yp).expand(batch + yp.shape)],
        dim=-2)
    return dataclasses.replace(
        state, points_sampled=x, points_sampled_value=y, chol_K=chol,
        K_inv_y=linalg.cho_solve(chol, y_centered), mean=mean,
        inv_chol_K=inv_chol, point_noise=pn)


def fantasy_update_vector(state: GaussianProcessState, union_points,
                          eval_points, chol_union: torch.Tensor,
                          derivatives_to_sample: Sequence[int] = ()
                          ) -> torch.Tensor:
    """sigma_tilde(a) = PostCov(a, U) C^-T, the one-shot fantasy map: for
    fantasy observations y_U = mu_U + C z (C the lower Cholesky factor of
    the union's posterior covariance plus noise) the fantasized posterior
    mean is mu(a) + sigma_tilde(a) z.  Returns (..., n_eval (1 + ms),
    n_union_channels)."""
    cross = posterior_covariance(state, eval_points, union_points,
                                 derivatives_to_sample)
    return linalg.solve_triangular(chol_union, cross.transpose(-1, -2),
                                   lower=True).transpose(-1, -2)


def sample_point_from_gp(generator: Optional[torch.Generator],
                         state: GaussianProcessState, point_to_sample,
                         noise_variance=None,
                         normal: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """One noisy observation drawn from one GP's posterior at a point (d,)
    or (1, d): mu + sqrt(var + noise) z.  ``noise_variance`` defaults to
    the value channel's; ``normal`` is the standard normal z, drawn from
    ``generator`` when not given."""
    pts = point_to_sample.reshape(1, -1)
    mu = posterior_mean(state, pts)[0, 0]
    var = posterior_variance(state, pts)[0, 0]
    if noise_variance is None:
        noise_variance = state.noise_variance[0]
    std = torch.sqrt(torch.clamp(var, min=0.0) + noise_variance)
    if normal is None:
        normal = torch.randn((), generator=generator, dtype=mu.dtype,
                             device=mu.device)
    return mu + std * normal


def sample_points_from_gp(generator: Optional[torch.Generator],
                          state: GaussianProcessState, points_to_sample,
                          jitter: float = 1e-10,
                          normals: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """A joint draw of one GP's latent values at points (q, d): mu + L z,
    L the Cholesky factor of the posterior variance plus ``jitter``;
    ``normals`` (q,) are z, drawn from ``generator`` when not given."""
    pts = points_to_sample.reshape(-1, state.dim)
    mu = posterior_mean(state, pts)[:, 0]
    chol = posterior_cholesky_variance(state, pts, jitter=jitter)
    if normals is None:
        normals = torch.randn((pts.shape[0],), generator=generator,
                              dtype=mu.dtype, device=mu.device)
    return mu + chol @ normals
