"""Carry state from the JAX package into the port, through numpy arrays.

The JAX package's fitted GP (``GaussianProcessState``, single or stacked
over an ensemble), its MCMC walker state, a random-feature sample
(``RandomFeatureSample``) and the inputs of a PES state can be exported as
numpy arrays (``np.asarray`` of each field); these functions turn such
arrays into the port's objects on a chosen device and dtype, so both
packages can compute the same thing from the same state.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from cornell_moe_tpu_torch.acquisition import pes as pes_mod
from cornell_moe_tpu_torch.models import covariance as cov_mod
from cornell_moe_tpu_torch.models.gp import GaussianProcessState
from cornell_moe_tpu_torch.ops.random_features import RandomFeatureSample

# Array fields of a GP state, under the JAX package's names
# ("hyperparameters" is the covariance's).
GP_STATE_FIELDS = ("hyperparameters", "noise_variance", "points_sampled",
                   "points_sampled_value", "chol_K", "K_inv_y", "mean",
                   "inv_chol_K", "point_noise")


# The inputs of make_pes_state, under its argument names.
PES_STATE_INPUTS = ("x_samples", "y", "x_min", "hess_at_min", "sigma",
                    "lengths", "noise")


def _tensor(a, device, dtype) -> torch.Tensor:
    return torch.as_tensor(np.array(a), dtype=dtype, device=device)


def gp_state_from_arrays(arrays: Mapping[str, Optional[np.ndarray]],
                         kernel_name: str, device=None,
                         dtype=torch.float64) -> GaussianProcessState:
    """A port GP state from the JAX state's arrays.

    A stacked JAX ensemble (leading axis S on every array) becomes an
    ensemble state; ``inv_chol_K`` and ``point_noise`` may be None.  The
    observed derivative channels come from the mapping's ``"derivatives"``
    entry (the JAX state's static field; none when absent);
    ``noise_variance`` is then (S, 1 + m) and ``points_sampled_value``
    (S, n, 1 + m).
    """
    def t(name):
        a = arrays.get(name)
        return None if a is None else _tensor(a, device, dtype)

    return GaussianProcessState(
        covariance=cov_mod.COVARIANCE_TYPES[kernel_name](
            hyperparameters=t("hyperparameters")),
        noise_variance=t("noise_variance"),
        points_sampled=t("points_sampled"),
        points_sampled_value=t("points_sampled_value"),
        chol_K=t("chol_K"), K_inv_y=t("K_inv_y"), mean=t("mean"),
        inv_chol_K=t("inv_chol_K"), point_noise=t("point_noise"),
        derivatives=tuple(int(i) for i in arrays.get("derivatives", ())))


def gp_state_to_arrays(state: GaussianProcessState) -> dict:
    """The port state's arrays under :data:`GP_STATE_FIELDS` names, and its
    observed derivative channels under ``"derivatives"``."""
    out = {"hyperparameters": state.covariance.hyperparameters}
    for name in GP_STATE_FIELDS[1:]:
        out[name] = getattr(state, name)
    out = {k: None if v is None else v.detach().cpu().numpy()
           for k, v in out.items()}
    out["derivatives"] = tuple(state.derivatives)
    return out


def set_mcmc_walkers(model, p0: np.ndarray, hypers: Optional[np.ndarray]
                     = None) -> None:
    """Give a port ``GaussianProcessLogLikelihoodMCMC`` the JAX model's
    walker positions ``p0`` (W, D) (marking burn-in done) and, when given,
    its picked log-hyperparameter samples ``hypers`` (S, D)."""
    model.p0 = torch.as_tensor(np.array(p0), dtype=model.dtype,
                               device=model.device)
    model.burned = True
    if hypers is not None:
        model.hypers = np.asarray(hypers, dtype=float)


def random_feature_sample_from_arrays(arrays: Mapping[str, np.ndarray],
                                      device=None, dtype=torch.float64
                                      ) -> RandomFeatureSample:
    """A port random-feature sample from a JAX ``RandomFeatureSample``'s
    arrays (``w``, ``b``, ``theta``, ``scale``; stacked samples keep their
    leading axes)."""
    return RandomFeatureSample(*[_tensor(arrays[name], device, dtype)
                                 for name in RandomFeatureSample._fields])


def pes_state_from_arrays(arrays: Mapping[str, np.ndarray], device=None,
                          dtype=torch.float64) -> pes_mod.PESState:
    """The port's PES state (EP included) from the inputs a JAX
    ``make_pes_state`` call took, under :data:`PES_STATE_INPUTS` names;
    per-set inputs may carry a leading axis of the sets."""
    return pes_mod.make_pes_state(**{
        name: _tensor(arrays[name], device, dtype)
        for name in PES_STATE_INPUTS})
