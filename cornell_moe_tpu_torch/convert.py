"""Carry state from the JAX package into the port, through numpy arrays.

The JAX package's fitted GP (``GaussianProcessState``, single or stacked
over an ensemble), its MCMC walker state, a random-feature sample
(``RandomFeatureSample``), the inputs of a PES state and the compat layer's
models (``GaussianProcess``, ``GaussianProcessMCMC``) and random draws (an
EI or KG object's MC normals, a multistart's Latin-hypercube starts) can be
exported as numpy arrays (``np.asarray`` of each field); these functions
turn such arrays into the port's objects on a chosen device and dtype, so
both packages can compute the same thing from the same state.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from cornell_moe_tpu_torch.acquisition import pes as pes_mod
from cornell_moe_tpu_torch.compat import covariance as cov_c
from cornell_moe_tpu_torch.compat import gaussian_process as gp_c
from cornell_moe_tpu_torch.compat import knowledge_gradient_mcmc as kgm_c
from cornell_moe_tpu_torch.models import covariance as cov_mod
from cornell_moe_tpu_torch.models.gp import GaussianProcessState
from cornell_moe_tpu_torch.ops.random_features import RandomFeatureSample
from cornell_moe_tpu_torch.utils.data_containers import HistoricalData

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


def compat_model_to_arrays(model) -> dict:
    """The arrays of a compat ``GaussianProcess`` or ``GaussianProcessMCMC``
    of either package: ``kernel_name``, ``hyperparameters`` ((1 + d,), or
    (S, 1 + d) for an ensemble), ``noise_variance``, the historical data's
    ``points_sampled`` and ``points_sampled_value``, and ``derivatives``."""
    data = model._historical_data
    if hasattr(model, "_hypers"):                # GaussianProcessMCMC
        kernel_name, hypers, noise = model._kernel_name, model._hypers, \
            model._noises
    else:
        cov = model._covariance
        kernel_name, hypers, noise = cov.covariance_type, \
            cov.get_hyperparameters(), model._noise_variance
    return {"kernel_name": kernel_name, "hyperparameters": np.array(hypers),
            "noise_variance": np.array(noise),
            "points_sampled": np.array(data.points_sampled),
            "points_sampled_value": np.array(data.points_sampled_value),
            "derivatives": tuple(int(i) for i in model._derivatives)}


def compat_model_from_arrays(arrays: Mapping, device=None, dtype=None):
    """The port's compat ``GaussianProcess`` (hyperparameters (1 + d,)) or
    ``GaussianProcessMCMC`` ((S, 1 + d)) from
    :func:`compat_model_to_arrays`' arrays, fitted on ``device`` in
    ``dtype`` (the compat layer's defaults when None)."""
    derivatives = tuple(arrays.get("derivatives", ()))
    x = np.asarray(arrays["points_sampled"], dtype=float)
    data = HistoricalData(dim=x.shape[1], num_derivatives=len(derivatives))
    data.append_historical_data(x, arrays["points_sampled_value"])
    hypers = np.asarray(arrays["hyperparameters"], dtype=float)
    if hypers.ndim == 2:
        return kgm_c.GaussianProcessMCMC(
            hypers, arrays["noise_variance"], data, derivatives,
            arrays["kernel_name"], device=device, dtype=dtype)
    cov = cov_c.COVARIANCE_TYPES_TO_CLASSES[arrays["kernel_name"]](
        hypers, device=device, dtype=dtype)
    return gp_c.GaussianProcess(cov, arrays["noise_variance"], data,
                                derivatives)


def carry_normals(obj, normals: np.ndarray) -> None:
    """Give a port compat EI or KG object (``ExpectedImprovement``,
    ``ExpectedImprovementMCMC``, ``KnowledgeGradient``,
    ``KnowledgeGradientMCMC``) the MC normals of its JAX counterpart (its
    ``_normals``, (num_mc, q + p)), on the object's device and dtype."""
    obj._normals = _tensor(normals, obj.device, obj.dtype)


def starts_from_array(starts: np.ndarray, device=None,
                      dtype=torch.float64) -> torch.Tensor:
    """A multistart's Latin-hypercube start blocks as the JAX package drew
    them ((B, q, d) numpy) for the port's multistart optimizers."""
    return _tensor(starts, device, dtype)
