"""The counter ``model.lml_plain`` on the port's d-KG model: seeded Branin
data with both partials observed, n 20 padded to 32, in float64.  It grows
by the evaluations of a batch of the plain LML wherever it runs, by W per
log posterior of W walkers, not on kernel B's path, and with a program's
replays on the card, where the chain's float64 walkers launch the tiled
Cholesky (``kernels.lml_chol_f64``) once per log posterior.
"""

import numpy as np
import pytest
import torch

from cornell_moe_tpu_torch.models import covariance as cov_mod
from cornell_moe_tpu_torch.models import likelihood as lik_mod
from cornell_moe_tpu_torch.models import mcmc
from cornell_moe_tpu_torch.utils import logging_utils as lu
from cornell_moe_tpu_torch.utils.data_containers import HistoricalData
from cornell_moe_tpu_torch.utils.synthetic_functions import \
    BraninWithDerivatives

F64 = torch.float64
N, BUCKET, WALKERS = 20, 16, 4
DS = (0, 1)
COUNTER = "model.lml_plain"


def branin_data(seed=24):
    """Points (N, 2) over Branin's domain and values (N, 3): the value
    and both partials."""
    fn = BraninWithDerivatives()
    dom = fn._search_domain
    rng = np.random.default_rng(seed)
    x = rng.uniform(dom[:, 0], dom[:, 1], (N, 2))
    return x, np.stack([fn.evaluate_true(p) for p in x])


def walkers(seed=7):
    """Walkers (W, 6) [log a, log l (2), log noise (3)] inside the
    prior's support."""
    rng = np.random.default_rng(seed)
    return torch.tensor(np.concatenate([
        rng.uniform(-0.5, 0.5, (WALKERS, 1)),
        rng.uniform(-1.0, 1.0, (WALKERS, 2)),
        rng.uniform(-6.0, -2.0, (WALKERS, 3))], axis=1), dtype=F64)


def port_model(x, values, derivatives=DS):
    data = HistoricalData(dim=2, num_derivatives=len(derivatives))
    data.append_sample_points(list(zip(x, values)))
    return mcmc.GaussianProcessLogLikelihoodMCMC(
        data, derivatives=derivatives, noisy=True, bucket=BUCKET,
        standardize=True, n_hypers=WALKERS, device="cpu", dtype=F64,
        generator=torch.Generator().manual_seed(0))


def grew(before):
    return lu.growth(before).get(COUNTER, 0)


@pytest.mark.parametrize("batch", [(), (1,), (3,), (2, 3)])
def test_counter_grows_by_the_batch_on_a_direct_call(batch):
    x, values = branin_data()
    h = torch.exp(walkers()[:, :3])
    h = h[0] if not batch else \
        h[torch.arange(int(np.prod(batch))) % WALKERS].reshape(batch + (3,))
    cov = cov_mod.COVARIANCE_TYPES["matern_2.5"](hyperparameters=h)
    noise = torch.full(batch + (3,), 1e-2, dtype=F64)
    before = lu.counters()
    lml = lik_mod.log_marginal_likelihood(
        cov, noise, torch.as_tensor(x), torch.as_tensor(values), DS)
    assert lml.shape == batch
    assert grew(before) == int(np.prod(batch))


def test_counter_grows_by_the_walkers_of_a_log_posterior():
    model = port_model(*branin_data())
    args = model._padded_data()
    before = lu.counters()
    model.log_posterior(walkers(), *args)
    assert grew(before) == WALKERS
    model.log_posterior(walkers()[:1], *args)
    assert grew(before) == WALKERS + 1


def test_counter_stays_on_kernel_b_path(monkeypatch):
    """Value channels where the gate sends them to kernel B (its plain
    stand-in here) count nothing; ``force_plain`` counts."""
    x, values = branin_data()
    model = port_model(x, values[:, :1], ())
    calls = []

    def lml_fused(us, amp, nv, yb, n, kernel_name):
        calls.append(us.shape[0])
        zero = torch.zeros(us.shape[0], dtype=us.dtype)
        return zero, zero
    monkeypatch.setattr(mcmc, "uses_lml_kernel", lambda *a: True)
    monkeypatch.setattr(mcmc.kernels, "lml_fused", lml_fused)
    thetas = walkers()[:, :4]
    args = model._padded_data()
    before = lu.counters()
    model.log_posterior(thetas, *args)
    assert calls == [WALKERS]
    assert grew(before) == 0
    model.log_posterior(thetas, *args, force_plain=True)
    assert grew(before) == WALKERS


def test_counter_growth_is_added_back_at_each_replay():
    """What a capture records of the counter is what each replay adds
    (``Program._capture_graph`` and ``Program.__call__`` on the card)."""
    model = port_model(*branin_data())
    args = model._padded_data()
    before = lu.counters()
    model.log_posterior(walkers(), *args)
    growth = lu.growth(before)
    lu.restore_counters(before)
    assert growth == {COUNTER: WALKERS}
    for _ in range(3):
        for name, n in growth.items():
            lu.count(name, n)
    assert grew(before) == 3 * WALKERS


def run_dkg_chain(device):
    """A d-KG chain of 12 walkers and 136 steps through its segment
    programs (captured and replayed on the card); returns its model."""
    x, values = branin_data()
    data = HistoricalData(dim=2, num_derivatives=2)
    data.append_sample_points(list(zip(x, values)))
    model = mcmc.GaussianProcessLogLikelihoodMCMC(
        data, derivatives=DS, noisy=True, bucket=BUCKET, standardize=True,
        n_hypers=12, device=device, dtype=F64,
        generator=torch.Generator(device=device).manual_seed(3))
    xx, yy, pn = model._padded_data()
    segment_fn = model._segment_program(xx, yy, pn)
    p0 = walkers(11).repeat(3, 1).to(device)
    mcmc.run_ensemble_mcmc(
        model.generator, lambda t: model.log_posterior(t, xx, yy, pn), p0,
        136, segment_fn=segment_fn)
    return model


@pytest.mark.parametrize("device", ["cpu", pytest.param(
    "cuda", marks=pytest.mark.cuda)])
def test_chain_counts_walkers_times_steps_plus_one(device):
    """The chain counts W at its start and W per step; 64 + 64 + 8 steps
    build two programs and replay the first."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    before = lu.counters()
    model = run_dkg_chain(device)
    assert grew(before) == 12 * (136 + 1)
    assert len(model.program_cache) == 2
    model.program_cache.release()


@pytest.mark.cuda
def test_chain_launches_the_tiled_cholesky_with_each_count():
    """On the card the chain's float64 d-KG walkers go through the tiled
    Cholesky (``kernels.lml_chol_f64``): one launch per log posterior, 12
    walkers at the start and 6 a half-step, so it and ``model.lml_plain``
    grow together, through captures and replays alike."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    before = lu.counters()
    model = run_dkg_chain("cuda")
    launches = lu.growth(before).get("kernels.lml_chol_f64", 0)
    assert launches == 1 + 2 * 136
    assert grew(before) == 12 + 6 * (launches - 1)
    model.program_cache.release()
