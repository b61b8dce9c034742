"""Checkpoint and resume of Bayesian-optimization runs.

Counterpart of ``cornell_moe_tpu/utils/checkpoint.py``, in the same format:
one ``.npz`` holding the HistoricalData arrays, the MCMC walker positions
and hyperparameter samples, and a JSON manifest (format version 1) under the
same array names, written atomically (a tmp file, then ``os.replace``).

The port draws every random number from one ``torch.Generator``, which the
driver shares with its MCMC model; its ``get_state()`` is stored as
``torch_generator_state``.  A checkpoint written by the JAX package has
threefry keys instead (``mcmc_key``, ``rng_key``), which have no torch
counterpart: restoring one ignores them and seeds the generator from the
caller's ``seed``.  Its data, walker positions and hyperparameter samples
carry over.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

from cornell_moe_tpu_torch import config
from cornell_moe_tpu_torch.utils.data_containers import HistoricalData

FORMAT_VERSION = 1


def save_checkpoint(path: str, historical_data, mcmc_model=None,
                    generator: Optional[torch.Generator] = None,
                    metadata: Optional[dict] = None) -> None:
    """Write a resumable checkpoint: the data, the MCMC model's walker
    state and settings, the generator's state and ``metadata``."""
    arrays = {
        "points_sampled": historical_data.points_sampled,
        "points_sampled_value": historical_data.points_sampled_value,
        "points_sampled_noise_variance":
            historical_data.points_sampled_noise_variance,
    }
    manifest = {
        "format_version": FORMAT_VERSION,
        "dim": historical_data.dim,
        "num_derivatives": historical_data.num_derivatives,
        "metadata": metadata or {},
    }
    if mcmc_model is not None:
        manifest["mcmc"] = {
            "burned": mcmc_model.burned,
            "n_hypers": mcmc_model.n_hypers,
            "chain_length": mcmc_model.chain_length,
            "burnin_steps": mcmc_model.burnin_steps,
            "noisy": mcmc_model.noisy,
            "kernel_name": mcmc_model.kernel_name,
            "derivatives": list(mcmc_model.derivatives),
            "bucket": mcmc_model.bucket,
            "standardize": bool(mcmc_model.standardize),
            "chain_gate_tol": mcmc_model.chain_gate_tol,
        }
        if mcmc_model.p0 is not None:
            arrays["mcmc_walker_positions"] = \
                mcmc_model.p0.detach().cpu().numpy()
        if mcmc_model.hypers is not None:
            arrays["mcmc_hypers"] = np.asarray(mcmc_model.hypers)
    if generator is not None:
        arrays["torch_generator_state"] = generator.get_state().numpy()
    arrays["manifest"] = np.frombuffer(
        json.dumps(manifest).encode(), dtype=np.uint8)

    tmp = path + ".tmp.npz"
    np.savez_compressed(tmp, **arrays)
    os.replace(tmp, path)


def load_checkpoint(path: str):
    """Read a checkpoint: (HistoricalData, manifest dict, arrays dict)."""
    with np.load(path, allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files}
    manifest = json.loads(bytes(arrays.pop("manifest")).decode())
    if manifest["format_version"] > FORMAT_VERSION:
        raise ValueError(
            f"checkpoint format {manifest['format_version']} is newer "
            f"than supported ({FORMAT_VERSION})")
    data = HistoricalData(manifest["dim"], manifest["num_derivatives"])
    data.append_historical_data(
        arrays["points_sampled"], arrays["points_sampled_value"],
        arrays["points_sampled_noise_variance"])
    return data, manifest, arrays


def restore_mcmc_model(path: str, prior=None,
                       generator: Optional[torch.Generator] = None,
                       seed: int = 0, device=None, dtype=None,
                       return_arrays: bool = False):
    """Rebuild a ``GaussianProcessLogLikelihoodMCMC`` from a checkpoint on
    ``device`` in ``dtype`` (the model's defaults when None).

    ``burned``, the walker positions ``p0``, the hyperparameter samples
    (refitted into the ensemble), the derivative channels, the shape
    bucket, ``standardize`` and ``chain_gate_tol`` are restored, so the
    next ``train()`` skips burn-in and continues the chain.  The model
    draws from ``generator`` (a new one on the device when None), set to
    the stored ``torch_generator_state`` when the checkpoint has one and
    seeded from ``seed`` when it does not (a checkpoint of the JAX
    package).  With ``return_arrays`` the raw arrays come back third.
    """
    from cornell_moe_tpu_torch.models.mcmc import \
        GaussianProcessLogLikelihoodMCMC

    data, manifest, arrays = load_checkpoint(path)
    cfg = manifest.get("mcmc")
    if cfg is None:
        raise ValueError(f"{path} holds no MCMC state")
    device = torch.device(device) if device is not None else \
        config.default_device()
    if generator is None:
        generator = torch.Generator(device=device)
    if "torch_generator_state" in arrays:
        generator.set_state(torch.as_tensor(arrays["torch_generator_state"]))
    else:
        generator.manual_seed(seed)
    model = GaussianProcessLogLikelihoodMCMC(
        data, prior=prior, chain_length=cfg["chain_length"],
        burnin_steps=cfg["burnin_steps"], n_hypers=cfg["n_hypers"],
        noisy=cfg["noisy"], kernel_name=cfg["kernel_name"],
        generator=generator, bucket=int(cfg.get("bucket", 0)),
        standardize=bool(cfg.get("standardize", False)),
        chain_gate_tol=cfg.get("chain_gate_tol"), device=device,
        dtype=dtype, derivatives=tuple(cfg.get("derivatives", ())))
    model.burned = cfg["burned"]
    if "mcmc_walker_positions" in arrays:
        model.p0 = torch.as_tensor(arrays["mcmc_walker_positions"],
                                   dtype=model.dtype, device=model.device)
    if "mcmc_hypers" in arrays:
        model.hypers = np.asarray(arrays["mcmc_hypers"])
        model._finalize_models()
    if return_arrays:
        return model, manifest, arrays
    return model, manifest
