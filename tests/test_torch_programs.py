"""The port's programs per shape bucket (``ops/programs.py``).

The counterpart of ``tests/test_compile_stability.py``: a driver loop
builds its programs in the first iteration of a shape bucket and none
inside it.  On the CPU a program calls its function directly, so these
tests hold the cache, its keys and its build counts, and hold the segment
chain (draws taken step by step from the model's generator before each
segment) to the step-by-step chain bit for bit in float64; the chain stays
eager under a process group.  The kernel and program switches and the
gated chain's ``min_segments`` are held to the JAX package's on the same
inputs (JAX is imported inside those tests only).

The tests marked ``cuda`` need a card and skip without one (on the card,
without JAX: ``python -m pytest tests/test_torch_programs.py -q
--noconftest -m cuda``).  There the captured CUDA graphs must equal
``CAPTURE = "never"`` bit for bit (chain, fit, suggest, recommendation),
the kernel launch counters must add each replay's launches, and a replay
must not overwrite the outputs an earlier call handed back.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from cornell_moe_tpu_torch import bayes_opt as tbo
from cornell_moe_tpu_torch import config
from cornell_moe_tpu_torch.acquisition import knowledge_gradient as tkg
from cornell_moe_tpu_torch.models import covariance as tcov
from cornell_moe_tpu_torch.models import mcmc as tmcmc
from cornell_moe_tpu_torch.ops import kernels, optimizers, programs
from cornell_moe_tpu_torch.utils import synthetic_functions as tsf
from cornell_moe_tpu_torch.utils.data_containers import (HistoricalData,
                                                         SamplePoint)

F64 = torch.float64


def _loop(capture, monkeypatch, iterations=4, device="cpu"):
    """tests/test_compile_stability.py's loop: Branin, KG, q = 1, bucket 4,
    3 initial points, 4 members (8 walkers), chain 20; builds of
    initialize and of each iteration, and each iteration's results."""
    monkeypatch.setattr(programs, "CAPTURE", capture)
    fast = optimizers.GradientDescentParameters(
        num_multistarts=4, max_num_steps=5, max_num_restarts=1,
        num_steps_averaged=2, gamma=0.7, pre_mult=1.0,
        max_relative_change=0.5)
    bo = tbo.BayesianOptimizer(
        objective_func=tsf.Branin(), method="KG", num_to_sample=1,
        num_mc=16, n_hypers=4, chain_length=20, burnin_steps=20,
        noisy=False, sgd_params=fast, verbose=False, shape_bucket=4,
        device=device)
    programs.reset_builds()
    bo.initialize(num_init_pts=3)
    builds = [programs.build_count()]
    results = []
    for _ in range(iterations):
        start = programs.build_count()
        pts, voi = bo.suggest()
        bo.observe(pts)
        rec = bo.recommend(num_eval_pts=64)
        builds.append(programs.build_count() - start)
        results.append((pts, voi, rec, bo.model.p0.cpu().numpy()))
    return bo, builds, results


def test_bo_loop_builds_once_per_bucket(monkeypatch):
    """As tests/test_compile_stability.py counts: initialize builds the
    chain (64-step segment and the 20-step burn-in) and the fit at n = 3
    -> 4; iteration 0 builds the suggest's two steps (the seeding q-EI's
    and the warm KG's) and the recommendation's grid and step; iteration 1
    retrains at n = 5 -> 8 (chain, fit and recommendation again),
    iteration 2 suggests at 8 (the last of the wave), and iteration 3
    builds nothing.  The same loop with CAPTURE = "never" builds nothing
    and gives the same points, VOIs, recommendations and walkers bit for
    bit."""
    bo, builds, results = _loop("auto", monkeypatch)
    assert builds == [3, 4, 4, 2, 0], builds
    kinds = sorted({key[0] for key in bo.program_cache.programs()})
    assert kinds == ["chain", "fit", "kg_warm_step", "qei_step",
                     "recommend_grid", "recommend_step"]
    assert all(p.replays > 0
               for p in bo.program_cache.programs().values())
    _, eager_builds, eager = _loop("never", monkeypatch)
    assert eager_builds == [0] * 5
    for got, ref in zip(results, eager):
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _chain_model(rng, n=20, bucket=16):
    x = rng.random((n, 2))
    y = np.sin(3 * x[:, 0]) + x[:, 1] ** 2
    data = HistoricalData(2)
    data.append_historical_data(x, y)
    return tmcmc.GaussianProcessLogLikelihoodMCMC(
        data, n_hypers=8, noisy=True, bucket=bucket, device="cpu",
        generator=torch.Generator().manual_seed(3))


@pytest.mark.parametrize("runner", ["fixed", "fixed_remainder", "gated"])
def test_segment_chain_equals_step_by_step(runner):
    """The segment chain (each segment's draws taken first, in the
    step-by-step order, then the steps from them; here through a program
    of the model's cache) against the step-by-step chain from the same
    generator seed, float64, bit for bit: a fixed chain of whole segments,
    one with a remainder (2000 = 31 x 64 + 16, cut to 3 x 16 + 5 with
    16-step segments) and the gated chain."""
    model = _chain_model(np.random.default_rng(0))
    x, y, pn = model._padded_data()

    def log_prob(t):
        return model.log_posterior(t, x, y, pn)

    p0 = model.prior.sample_from_prior(
        torch.Generator().manual_seed(1), 8, dtype=F64).clamp(-19.9, 19.9)
    segment_fn = model._segment_program(x, y, pn)
    out = []
    for fn in (segment_fn, None):
        g = torch.Generator().manual_seed(2)
        if runner == "gated":
            pos, lp, steps = tmcmc.run_ensemble_mcmc_gated(
                g, log_prob, p0, 400, rel_tol=1.0, segment_fn=fn)
        else:
            n, seg = (128, 64) if runner == "fixed" else (53, 16)
            pos, lp = tmcmc.run_ensemble_mcmc(g, log_prob, p0, n,
                                              segment_fn=fn, segment=seg)
            steps = n
        out.append((pos.numpy(), lp.numpy(), steps,
                    torch.rand(4, generator=g).numpy()))
    for a, b in zip(*out):
        np.testing.assert_array_equal(a, b)
    built = {k[4]: p.replays
             for k, p in model.program_cache.programs().items()}
    assert built == {"fixed": {64: 2}, "fixed_remainder": {16: 3, 5: 1},
                     "gated": {64: out[0][2] // 64}}[runner]


def test_draw_segment_takes_the_step_by_step_numbers():
    g1, g2 = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    u, idx, acc = tmcmc.draw_segment(g1, 3, 6, dtype=F64)
    assert u.shape == idx.shape == acc.shape == (3, 2, 3)
    for k in range(3):
        for h, (uu, ii, aa) in enumerate(tmcmc.draw_stretch_moves(
                g2, 6, dtype=F64)):
            assert torch.equal(u[k, h], uu) and torch.equal(idx[k, h], ii)
            assert torch.equal(acc[k, h], aa)


def test_model_train_programs_equal_eager(monkeypatch):
    """train(), then add_sampled_points (a refit inside the bucket) and a
    retrain, with programs and with CAPTURE = "never": walkers, hypers and
    the ensemble's factors bit for bit; with programs the retrain builds
    nothing."""
    out = []
    for capture in ("auto", "never"):
        monkeypatch.setattr(programs, "CAPTURE", capture)
        model = _chain_model(np.random.default_rng(0))
        model.burnin_steps, model.chain_length = 70, 200
        model.chain_gate_tol = 1.0
        model.train()
        builds = programs.build_count()
        model.add_sampled_points([SamplePoint([0.3, 0.6], 0.5)])
        model.train()
        out.append((model.p0.numpy(), model.hypers,
                    model.models.chol_K.numpy(),
                    model.models.K_inv_y.numpy(), model.chain_steps))
        if capture == "auto":
            assert programs.build_count() == builds
            assert len(model.program_cache) == 3
        else:
            assert len(model.program_cache) == 0
    for a, b in zip(*out):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_chain_stays_eager_under_a_process_group(tmp_path):
    """Under a process group (a gloo world of one) the chain runs step by
    step and the recommendation eagerly, each by its named rule; the fit
    (no collective) still runs as a program."""
    assert tmcmc.chain_runs_programs(None)
    assert tbo.recommend_runs_program(None)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        group = dist.group.WORLD
        assert not tmcmc.chain_runs_programs(group)
        assert not tbo.recommend_runs_program(group)
        model = _chain_model(np.random.default_rng(0))
        model.process_group = group
        model.burnin_steps, model.chain_length = 10, 10
        model.train()
        assert {k[0] for k in model.program_cache.programs()} == {"fit"}
        rec = tbo.recommend_from_guesses(
            model.models, tkg.inner_domain(
                tbo.TensorProductDomain.from_bounds([[0, 1], [0, 1]]), 0),
            torch.rand(16, 2, dtype=F64), params=tbo.DEFAULT_SGD_PARAMS_PS,
            group=group, program_cache=model.program_cache)
        assert rec.shape == (2,)
        assert {k[0] for k in model.program_cache.programs()} == {"fit"}
    finally:
        dist.destroy_process_group()


def test_cfkg_outer_steps_stay_eager(monkeypatch):
    """With a fidelity dim the warm KG step stays eager by its named rule
    (the fidelity cost's torch.prod backward reads the host); the seeding
    q-EI's step and the other stages still run as programs, and the
    iteration equals its CAPTURE = "never" twin bit for bit."""
    assert tkg.warm_step_runs_program(0)
    assert not tkg.warm_step_runs_program(1)
    fast = optimizers.GradientDescentParameters(
        num_multistarts=4, max_num_steps=8, max_num_restarts=1,
        num_steps_averaged=2, gamma=0.7, pre_mult=1.0,
        max_relative_change=0.5)
    out = []
    for capture in ("auto", "never"):
        monkeypatch.setattr(programs, "CAPTURE", capture)
        bo = tbo.BayesianOptimizer(
            objective_func=tsf.BraninFidelity(), method="KG",
            num_to_sample=2, num_mc=8, n_hypers=8, chain_length=25,
            burnin_steps=25, noisy=True, standardize=True,
            chain_gate_tol=None, sgd_params=fast, device="cpu",
            verbose=False)
        h = bo.run(num_iterations=1)[0]
        out.append((h["suggested"], h["voi"], h["recommended"]))
        kinds = {key[0] for key in bo.program_cache.programs()}
        assert kinds == ({"chain", "fit", "qei_step", "recommend_grid",
                          "recommend_step"} if capture == "auto" else set())
    for a, b in zip(*out):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_program_cache_counts_builds_and_replays():
    cache = programs.ProgramCache()
    programs.reset_builds()
    prog = cache.get(("a",), lambda t: (t + 1, None))
    assert cache.get(("a",), lambda t: t) is prog
    out, none = prog(torch.zeros(2))
    assert torch.equal(out, torch.ones(2)) and none is None
    prog(torch.ones(2))
    cache.get(("b",), lambda t: t)(torch.zeros(1))
    assert programs.build_count() == 2 and prog.replays == 2
    assert len(cache) == 2


def test_launch_counters_set_and_add():
    kernels.reset_launch_counts()
    kernels.add_launch_counts({"lml_fused": 3, "descent_run": 2})
    kernels.add_launch_counts({"lml_fused": 1})
    counts = kernels.launch_counts()
    assert counts["lml_fused"] == 4 and counts["descent_run"] == 2
    kernels.set_launch_counts({"lml_fused": 0})
    assert kernels.lml_fused_launches == 0
    with pytest.raises(KeyError):
        kernels.set_launch_counts({"no_such_kernel": 1})
    kernels.reset_launch_counts()


SWITCHES = {
    "lml": (tmcmc, "LML_PALLAS",
            lambda: tmcmc.uses_lml_kernel("cuda", torch.float32, ())),
    "descent": (tkg, "DESCENT_PALLAS",
                lambda: tkg.descent_kernel_for(
                    "cuda", torch.float32, "matern_2.5", (), (), 2, 4)
                is not None),
    "covariance": (tcov, "USE_PALLAS",
                   lambda: tcov.uses_covariance_kernel(
                       "cuda", torch.float32, (), "matern_2.5")),
    "capture": (programs, "CAPTURE", programs.enabled),
}


@pytest.mark.parametrize("switch", sorted(SWITCHES))
def test_switches(monkeypatch, switch):
    """"auto" opens each gate where its rule allows, "never" closes it, and
    any other value raises (the JAX package's "always" has no CUDA
    counterpart on a CPU tensor)."""
    module, name, gate = SWITCHES[switch]
    assert getattr(module, name) == "auto" and gate()
    monkeypatch.setattr(module, name, "never")
    assert not gate()
    monkeypatch.setattr(module, name, "always")
    with pytest.raises(ValueError):
        gate()
    assert config.SWITCH_VALUES == ("auto", "never")


def test_lml_switch_sends_the_chain_to_the_plain_lml(monkeypatch):
    """With the gate forced open (a counting stand-in for the kernel), the
    log posterior takes the kernel under LML_PALLAS "auto" and the plain
    LML under "never", with the same value."""
    model = _chain_model(np.random.default_rng(0))
    x, y, pn = model._padded_data()
    thetas = model.prior.sample_from_prior(
        torch.Generator().manual_seed(1), 4, dtype=F64).clamp(-5, 5)
    calls = []

    def counting_lml(*args):
        calls.append(1)
        return kernels.lml_fused_plain(*args)

    monkeypatch.setattr(kernels, "lml_fused", counting_lml)
    monkeypatch.setattr(tmcmc, "uses_lml_kernel",
                        lambda *a: tmcmc.LML_PALLAS == "auto")
    via_kernel = model.log_posterior(thetas, x, y, pn)
    monkeypatch.setattr(tmcmc, "LML_PALLAS", "never")
    plain = model.log_posterior(thetas, x, y, pn)
    assert len(calls) == 1
    np.testing.assert_allclose(via_kernel.numpy(), plain.numpy(),
                               rtol=1e-10)


@pytest.mark.parametrize("min_segments", [None, 5])
def test_min_segments_matches_jax(min_segments):
    """The gated chain on a standard normal with a loose gate (rel_tol
    50): the default floor (CHAIN_GATE_MIN_SEGMENTS = 2, effectively 3
    segments: the two-lag drift first exists at the third) stops both
    packages at 192 steps; min_segments = 5 forces 320 in both."""
    jmcmc = pytest.importorskip(
        "cornell_moe_tpu.models.mcmc",
        reason="the JAX package (the reference) does not import here")
    import jax
    import jax.numpy as jnp

    assert tmcmc.CHAIN_GATE_MIN_SEGMENTS == jmcmc.CHAIN_GATE_MIN_SEGMENTS
    p0 = np.random.default_rng(0).standard_normal((16, 3))
    kw = {} if min_segments is None else dict(min_segments=min_segments)
    _, _, j_steps = jmcmc.run_ensemble_mcmc_gated(
        jax.random.PRNGKey(0), lambda t: -0.5 * jnp.sum(t * t, axis=1),
        jnp.asarray(p0), 1000, rel_tol=50.0, **kw)
    _, _, t_steps = tmcmc.run_ensemble_mcmc_gated(
        torch.Generator().manual_seed(0),
        lambda t: -0.5 * torch.sum(t * t, dim=1), torch.as_tensor(p0),
        1000, rel_tol=50.0, **kw)
    expected = 192 if min_segments is None else 320
    assert int(j_steps) == t_steps == expected


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


def _card_model(dev, n=100):
    rng = np.random.default_rng(0)
    x = rng.random((n, 2))
    y = np.sin(3 * x[:, 0]) + x[:, 1] ** 2 + 0.01 * rng.standard_normal(n)
    data = HistoricalData(2)
    data.append_historical_data(x, y)
    return tmcmc.GaussianProcessLogLikelihoodMCMC(
        data, n_hypers=16, noisy=True, bucket=16, standardize=True,
        chain_gate_tol=1.0, burnin_steps=150, chain_length=200, device=dev,
        dtype=torch.float32,
        generator=torch.Generator(device=dev).manual_seed(0))


@pytest.mark.cuda
def test_captured_chain_and_fit_equal_eager(dev, monkeypatch):
    """train() with programs (CUDA graphs: the 64-step segment, the
    22-step burn-in remainder, the fit) and with CAPTURE = "never", float32
    on the card: walkers, chain steps and the ensemble's factors bit for
    bit, and the same launches of kernels B and C, the replays' counted."""
    out = []
    for capture in ("auto", "never"):
        monkeypatch.setattr(programs, "CAPTURE", capture)
        model = _card_model(dev)
        kernels.reset_launch_counts()
        model.train()
        torch.cuda.synchronize()
        out.append((kernels.launch_counts(), model.chain_steps,
                    model.p0.cpu().numpy(), model.models.chol_K.cpu().numpy(),
                    model.models.K_inv_y.cpu().numpy()))
        if capture == "auto":
            assert {k[0] for k in model.program_cache.programs()} == \
                {"chain", "fit"}
    (counts, *got), (ref_counts, *ref) = out
    assert counts == ref_counts and counts["lml_fused"] > 0 and \
        counts["covariance_with_noise"] > 0
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.cuda
def test_captured_recommend_equals_eager(dev, monkeypatch):
    """The recommendation's grid program and its step program (autograd
    inside the graph, the step size an input), replayed 1000 times,
    against the eager run on the same ensemble: the same point bit for
    bit."""
    model = _card_model(dev)
    model.train()
    dom = tbo.TensorProductDomain.from_bounds([[0, 1], [0, 1]], device=dev,
                                              dtype=torch.float32)
    guesses = torch.rand(500, 2, device=dev,
                         generator=torch.Generator(device=dev).manual_seed(1))
    cache = programs.ProgramCache()
    got = [tbo.recommend_from_guesses(model.models, dom, guesses,
                                      program_cache=cache)
           for _ in range(2)]
    monkeypatch.setattr(programs, "CAPTURE", "never")
    ref = tbo.recommend_from_guesses(model.models, dom, guesses,
                                     program_cache=cache)
    replays = {k[0]: p.replays for k, p in cache.programs().items()}
    assert replays == {"recommend_grid": 2, "recommend_step": 2000}
    for g in got:
        assert torch.equal(g, ref)


@pytest.mark.cuda
def test_captured_suggest_equals_eager(dev, monkeypatch):
    """Method "KG"'s suggest at a reduced width (40 starts, q = 2, 32
    draws) with its steps as programs (the seeding q-EI's and the warm KG
    multistart's, kernel A inside) and with CAPTURE = "never": the same
    discretization, points and VOI bit for bit, and the same launches of
    kernel A."""
    model = _card_model(dev)
    model.train()
    dom = tbo.TensorProductDomain.from_bounds([[0, 1], [0, 1]], device=dev,
                                              dtype=torch.float32)
    params = optimizers.GradientDescentParameters(
        num_multistarts=40, max_num_steps=20, max_num_restarts=2,
        num_steps_averaged=4, gamma=0.7, pre_mult=1.0,
        max_relative_change=0.5, tolerance=1e-10)
    out = []
    for capture in ("auto", "never"):
        monkeypatch.setattr(programs, "CAPTURE", capture)
        cache = programs.ProgramCache()
        gen = torch.Generator(device=dev).manual_seed(4)
        kernels.reset_launch_counts()
        discrete = tbo.seed_kg_discretization(
            gen, model.models, dom, qei_params=params, num_qei_pts=3,
            num_mc=64, conv_tol=3e-3, program_cache=cache)
        pts, voi = tbo._qkg_suggest_arrays(
            gen, model.models, dom, discrete, params,
            tbo.DEFAULT_SGD_PARAMS_PS, 2, 32, conv_tol=3e-3,
            program_cache=cache)
        torch.cuda.synchronize()
        out.append((discrete.cpu().numpy(), pts.cpu().numpy(),
                    voi.cpu().numpy(), kernels.launch_counts()))
        kinds = {k[0]: p.replays for k, p in cache.programs().items()}
        if capture == "auto":
            assert set(kinds) == {"qei_step", "kg_warm_step"}
            assert all(v > 0 for v in kinds.values())
        else:
            assert not kinds
    (*got, counts), (*ref, ref_counts) = out
    assert counts == ref_counts and counts["descent_run"] > 2
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
def test_replay_keeps_earlier_outputs(dev):
    """A fitted ensemble handed back by the fit's program stays as it was
    when the program replays for other hyperparameters, and each replay
    adds the capture's launches of kernel C."""
    cache = programs.ProgramCache()
    rng = np.random.default_rng(0)
    x, y = rng.random((64, 2)), rng.standard_normal(64)
    kw = dict(device=dev, dtype=torch.float32)

    def fit(scale):
        h = torch.tensor([[1.0, 0.3 * scale, 0.4]] * 4, **kw)
        return tmcmc.fit_gp_ensemble("matern_2.5", h,
                                     torch.full((4, 1), 1e-2, **kw), x, y,
                                     bucket=16, program_cache=cache)

    kernels.reset_launch_counts()
    first = fit(1.0)
    kept = first.chol_K.clone()
    second = fit(2.0)
    torch.cuda.synchronize()
    assert torch.equal(first.chol_K, kept)
    assert not torch.equal(first.chol_K, second.chol_K)
    assert kernels.launch_counts()["covariance_with_noise"] == 2
    prog, = cache.programs().values()
    assert prog.launch_growth == {"kernels": {"covariance_with_noise": 1}}
