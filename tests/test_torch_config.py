"""The port's entry points run on the card unless the caller asks for the
CPU: without a CUDA card, ``config.default_device()`` raises, and so do
the entry points that fall back on it when given no device; with
``device="cpu"`` they build on the CPU in float64."""

import pytest
import torch

from cornell_moe_tpu_torch import config
from cornell_moe_tpu_torch.bayes_opt import BayesianOptimizer
from cornell_moe_tpu_torch.models.mcmc import GaussianProcessLogLikelihoodMCMC
from cornell_moe_tpu_torch.utils.data_containers import HistoricalData
from cornell_moe_tpu_torch.utils.synthetic_functions import Branin


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_device_raises_without_a_card(no_card):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        config.default_device()


def test_default_device_is_the_first_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert config.default_device() == torch.device("cuda:0")


def test_optimizer_needs_a_device_without_a_card(no_card):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BayesianOptimizer(objective_func=Branin(), method="KG",
                          verbose=False)
    bo = BayesianOptimizer(objective_func=Branin(), method="KG",
                           device="cpu", verbose=False)
    assert bo.device == torch.device("cpu") and bo.dtype == torch.float64


def test_mcmc_model_needs_a_device_without_a_card(no_card):
    data = HistoricalData(2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GaussianProcessLogLikelihoodMCMC(data)
    model = GaussianProcessLogLikelihoodMCMC(data, device="cpu")
    assert model.device == torch.device("cpu")
    assert model.dtype == torch.float64


@pytest.mark.parametrize("value, dtype, on", [
    ("never", torch.float32, False),
    ("always", torch.float32, True),
    ("always", torch.float64, False),
    ("auto", torch.float32, False)])
def test_kg_fantasy_lowp_gate(monkeypatch, value, dtype, on):
    """The bfloat16 fantasy solve's gate: on only under "always" and only
    for float32; off by default, and off for any other value (the JAX
    package turns it on by itself only on a TPU backend; here, on the CPU,
    its gate reads the same)."""
    import jax.numpy as jnp

    from cornell_moe_tpu import config as jconfig

    assert config.KG_FANTASY_LOWP == jconfig.KG_FANTASY_LOWP == "never"
    monkeypatch.setattr(config, "KG_FANTASY_LOWP", value)
    monkeypatch.setattr(jconfig, "KG_FANTASY_LOWP", value)
    assert config.kg_fantasy_lowp_enabled(dtype) is on
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.float64
    assert jconfig.kg_fantasy_lowp_enabled(jdtype) is on
