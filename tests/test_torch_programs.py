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
from cornell_moe_tpu_torch.parallel import sharding
from cornell_moe_tpu_torch.utils import logging_utils as lu
from cornell_moe_tpu_torch.utils import synthetic_functions as tsf
from cornell_moe_tpu_torch.utils.data_containers import (HistoricalData,
                                                         SamplePoint)

F64 = torch.float64


def _launches(before):
    """Each kernel's launches since ``before`` (an ``lu.counters()``
    snapshot): the growth of its counter ``kernels.<name>``."""
    return {n[len("kernels."):]: v for n, v in lu.growth(before).items()
            if n.startswith("kernels.")}


def _loop(capture, monkeypatch, iterations=4, device="cpu"):
    """tests/test_compile_stability.py's loop: Branin, KG, q = 1, bucket 4,
    3 initial points, 4 members (8 walkers), chain 20; builds of
    initialize and of each iteration, each iteration's results, and the
    replays by program kind after each iteration."""
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
    start = programs.build_count()
    bo.initialize(num_init_pts=3)
    builds = [programs.build_count() - start]
    results, replays = [], []
    for _ in range(iterations):
        start = programs.build_count()
        pts, voi = bo.suggest()
        bo.observe(pts)
        rec = bo.recommend(num_eval_pts=64)
        builds.append(programs.build_count() - start)
        results.append((pts, voi, rec, bo.model.p0.cpu().numpy()))
        replays.append(_replays_by_kind(bo.program_cache))
    return bo, builds, results, replays


def _replays_by_kind(cache) -> dict:
    out = {}
    for key, prog in cache.programs().items():
        out[key[0]] = out.get(key[0], 0) + prog.replays
    return out


SUGGEST_KG = {"qei_step", "posterior_mean_step", "kg_cold", "kg_warm_step",
              "kg_score"}


def test_bo_loop_builds_once_per_bucket(monkeypatch):
    """As tests/test_compile_stability.py counts: initialize builds the
    chain (64-step segment and the 20-step burn-in) and the fit at n = 3
    -> 4; iteration 0 builds the suggest's five programs (the seeding
    q-EI's step and posterior-mean polish step, the KG multistart's cold
    evaluation and warm step, the VOI's scoring) and the recommendation's
    grid and step; iteration 1 retrains at n = 5 -> 8 (chain, fit and
    recommendation again), iteration 2 suggests at 8 (the last of the
    wave), and iteration 3 builds nothing and replays every suggest
    program.  The same loop with CAPTURE = "never" builds nothing and
    gives the same points, VOIs, recommendations and walkers bit for
    bit."""
    bo, builds, results, replays = _loop("auto", monkeypatch)
    assert builds == [3, 7, 4, 5, 0], builds
    kinds = sorted({key[0] for key in bo.program_cache.programs()})
    assert kinds == sorted(SUGGEST_KG | {"chain", "fit", "recommend_grid",
                                         "recommend_step"})
    assert all(p.replays > 0
               for p in bo.program_cache.programs().values())
    assert all(replays[3][k] > replays[2][k] for k in kinds), replays[2:]
    _, eager_builds, eager, _ = _loop("never", monkeypatch)
    assert eager_builds == [0] * 5
    for got, ref in zip(results, eager):
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_fantasy_switch_keys_the_kg_programs(monkeypatch):
    """``config.KG_FANTASY_LOWP`` is read when a program that builds a
    batched fantasy model is captured, so its value is part of every
    program's key (``programs.keyed_switch``, with the kernel switches).
    In float32, from the same generator state: a suggest under "never",
    then one under "always", which builds the suggest's five programs
    again (the two KG programs among them), then one under "never" again,
    which builds nothing and gives the first suggest's points and VOI bit
    for bit."""
    monkeypatch.setattr(programs, "CAPTURE", "auto")
    fast = optimizers.GradientDescentParameters(
        num_multistarts=4, max_num_steps=5, max_num_restarts=1,
        num_steps_averaged=2, gamma=0.7, pre_mult=1.0,
        max_relative_change=0.5)
    bo = tbo.BayesianOptimizer(
        objective_func=tsf.Branin(), method="KG", num_to_sample=2,
        num_mc=8, n_hypers=4, chain_length=20, burnin_steps=20,
        noisy=True, standardize=True, sgd_params=fast, verbose=False,
        shape_bucket=8, device="cpu", dtype=torch.float32)
    bo.initialize(num_init_pts=6)
    state = bo.generator.get_state()
    runs = []
    for value in ("never", "always", "never"):
        monkeypatch.setattr(config, "KG_FANTASY_LOWP", value)
        bo.generator.set_state(state)
        start = programs.build_count()
        pts, voi = bo.suggest()
        runs.append((pts, voi, programs.build_count() - start,
                     sorted(k[0] for k in bo.program_cache.programs())))
    assert runs[0][2] == 5
    assert runs[1][2] == 5 and runs[2][2] == 0
    always = sorted(k[0] for k in bo.program_cache.programs()
                    if ("config.KG_FANTASY_LOWP", "always") in k)
    assert {"kg_cold", "kg_warm_step"} <= set(always) and len(always) == 5
    assert runs[1][3] == sorted(runs[0][3] + always)
    np.testing.assert_array_equal(runs[2][0], runs[0][0])
    assert runs[2][1] == runs[0][1]


# each switch read inside captured functions: (module, attribute, its name
# in the keys, default, the other value)
KEYED_SWITCHES = {
    "lml": (tmcmc, "LML_PALLAS", "mcmc.LML_PALLAS", "auto", "never"),
    "covariance": (tcov, "USE_PALLAS", "covariance.USE_PALLAS", "auto",
                   "never"),
    "descent": (tkg, "DESCENT_PALLAS", "knowledge_gradient.DESCENT_PALLAS",
                "auto", "never"),
    "fantasy_lowp": (config, "KG_FANTASY_LOWP", "config.KG_FANTASY_LOWP",
                     "never", "always"),
}


@pytest.mark.parametrize("program", ["fit", "chain"])
@pytest.mark.parametrize("switch", sorted(KEYED_SWITCHES))
def test_switches_key_every_program(monkeypatch, switch, program):
    """Every program's key holds the value of each registered switch
    (``programs.keyed_switch``): under the default a program builds once
    in two calls, under the other value once more, and back under the
    default it builds nothing and replays the first program; the ensemble
    fit and a chain segment, float64 on the CPU (where no switch changes
    the arithmetic, so every call gives the same bits)."""
    module, name, qual, default, other = KEYED_SWITCHES[switch]
    assert dict(programs.switch_key()) == {
        q: d for _, _, q, d, _ in KEYED_SWITCHES.values()}
    monkeypatch.setattr(programs, "CAPTURE", "auto")
    model = _chain_model(np.random.default_rng(0))
    x, y, pn = model._padded_data()
    r = np.random.default_rng(1)
    if program == "fit":
        hypers = np.concatenate([0.8 + r.random((8, 1)),
                                 0.3 + 0.4 * r.random((8, 2))], axis=1)
        noises = np.full((8, 1), 1e-2)

        def run():
            return model._fit(hypers, noises).chol_K
    else:
        pos = model.prior.sample_from_prior(
            torch.Generator().manual_seed(1), 8, dtype=F64).clamp(-5, 5)
        lp = model.log_posterior(pos, x, y, pn)
        draws = tmcmc.draw_segment(torch.Generator().manual_seed(2), 4, 8,
                                   dtype=F64)
        segment = model._segment_program(x, y, pn)

        def run():
            return segment(pos, lp, *draws)[1]

    builds, outs = [], []
    for value in (default, default, other, default):
        monkeypatch.setattr(module, name, value)
        start = programs.build_count()
        outs.append(run())
        builds.append(programs.build_count() - start)
    assert builds == [1, 0, 1, 0]
    kind = "fit" if program == "fit" else "chain_4"
    assert programs.by_kind(model.program_cache) == {
        kind: {"builds": 2, "replays": 4}}
    replays = {value: p.replays
               for k, p in model.program_cache.programs().items()
               for value in (default, other) if (qual, value) in k}
    assert replays == {default: 3, other: 1}
    for out in outs[1:]:
        assert torch.equal(out, outs[0])


def _driver_runs(capture, monkeypatch, **kw):
    """Two iterations of a small driver inside one bucket (5 -> 7 -> 9
    observations, bucket 16) with ``CAPTURE`` = ``capture``: the history,
    the builds of each iteration (the first's initialize included) and the
    replays by kind after each."""
    monkeypatch.setattr(programs, "CAPTURE", capture)
    fast = optimizers.GradientDescentParameters(
        num_multistarts=4, max_num_steps=8, max_num_restarts=1,
        num_steps_averaged=2, gamma=0.7, pre_mult=1.0,
        max_relative_change=0.5)
    bo = tbo.BayesianOptimizer(**dict(dict(
        num_to_sample=2, num_mc=8, n_hypers=8, chain_length=25,
        burnin_steps=25, noisy=True, standardize=True, chain_gate_tol=None,
        sgd_params=fast, device="cpu", verbose=False), **kw))
    builds, replays = [], []
    for it in range(2):
        start = programs.build_count()
        bo.run(it + 1, num_init_pts=5, start_iteration=it)
        builds.append(programs.build_count() - start)
        replays.append(_replays_by_kind(bo.program_cache))
    return bo.history, builds, replays


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


def test_chain_stays_eager_under_a_process_group(tmp_path, monkeypatch):
    """The rule (``sharding.group_captures``): the chain and the
    recommendation stay eager only under a gloo group on a card; no group,
    an NCCL group and the CPU run them as programs.  On a gloo world of one
    on the CPU the chain's segments (the gather inside each program) and
    the recommendation's grid run through their programs, and the walkers,
    the ensemble and the recommendation equal the step-by-step eager run's
    (``CAPTURE = "never"``) bit for bit."""
    for rule in (tmcmc.chain_runs_programs, tbo.recommend_runs_program):
        assert rule(None, "cpu") and rule(None, "cuda:0")
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        group = dist.group.WORLD
        for rule in (tmcmc.chain_runs_programs, tbo.recommend_runs_program):
            assert rule(group, "cpu") and not rule(group, "cuda:0")
        with monkeypatch.context() as m:
            m.setattr(sharding.dist, "get_backend",
                      lambda g=None: dist.Backend.NCCL)
            assert tmcmc.chain_runs_programs(group, "cuda:0")
            assert tbo.recommend_runs_program(group, "cuda:0")
        out = []
        for capture in ("auto", "never"):
            monkeypatch.setattr(programs, "CAPTURE", capture)
            model = _chain_model(np.random.default_rng(0))
            model.process_group = group
            model.burnin_steps, model.chain_length = 70, 10
            model.train()
            rec = tbo.recommend_from_guesses(
                model.models, tkg.inner_domain(
                    tbo.TensorProductDomain.from_bounds([[0, 1], [0, 1]]),
                    0), torch.rand(16, 2, dtype=F64,
                                   generator=torch.Generator().manual_seed(1)),
                params=tbo.DEFAULT_SGD_PARAMS_PS, group=group,
                program_cache=model.program_cache)
            kinds = {k[0] for k in model.program_cache.programs()}
            assert kinds == ({"chain", "fit", "recommend_grid",
                              "recommend_step"} if capture == "auto"
                             else set())
            out.append((model.p0.numpy(), model.models.chol_K.numpy(),
                        rec.numpy()))
        for a, b in zip(*out):
            np.testing.assert_array_equal(a, b)
    finally:
        dist.destroy_process_group()


def test_cfkg_outer_steps_stay_eager(monkeypatch):
    """cf-KG's outer steps, named for the rule that once kept them eager,
    now run as programs: the fidelity cost's product is a chain of
    multiplications whose backward reads nothing from the host.  Over two
    iterations inside one bucket every suggest program (the warm step
    among them) is built in the first and replayed in the second, which
    builds nothing, and both iterations equal their CAPTURE = "never"
    twins bit for bit."""
    kw = dict(objective_func=tsf.BraninFidelity(), method="KG")
    got, builds, replays = _driver_runs("auto", monkeypatch, **kw)
    assert builds[0] > 0 and builds[1] == 0, builds
    assert SUGGEST_KG <= set(replays[1])
    assert all(replays[1][k] > replays[0][k] for k in SUGGEST_KG), replays
    ref, never_builds, _ = _driver_runs("never", monkeypatch, **kw)
    assert never_builds == [0, 0]
    for h, r in zip(got, ref):
        for k in ("suggested", "voi", "recommended"):
            np.testing.assert_array_equal(np.asarray(h[k]), np.asarray(r[k]))


def test_ei_suggest_programs_equal_never(monkeypatch):
    """Method "EI" (q = 2, the MC estimator) over two iterations inside one
    bucket: the single-GP multistart's GD step and the scoring (the
    union's posterior and the estimate in one program) are built in the
    first iteration and replayed in the second, which builds nothing; both
    equal CAPTURE = "never" bit for bit."""
    kw = dict(objective_func=tsf.Branin(), method="EI")
    got, builds, replays = _driver_runs("auto", monkeypatch, **kw)
    assert builds[0] > 0 and builds[1] == 0, builds
    for kind in ("ei_step", "ei_score"):
        assert replays[1][kind] > replays[0][kind] > 0, replays
    ref, _, _ = _driver_runs("never", monkeypatch, **kw)
    for h, r in zip(got, ref):
        for k in ("suggested", "voi", "recommended"):
            np.testing.assert_array_equal(np.asarray(h[k]), np.asarray(r[k]))


def _heuristic_and_map(capture, monkeypatch):
    """Heuristic q-EI (q = 3, kriging believer) twice on member 0 of a
    trained model, then its MAP fit from 3 starts twice, through one
    program cache; results, builds of each call and replays by kind."""
    from cornell_moe_tpu_torch.acquisition import expected_improvement as tei
    monkeypatch.setattr(programs, "CAPTURE", capture)
    model = _chain_model(np.random.default_rng(0))
    model.burnin_steps, model.chain_length = 20, 20
    model.train()
    member = model.models.member(0)
    dom = tbo.TensorProductDomain.from_bounds([[0, 1], [0, 1]])
    params = optimizers.GradientDescentParameters(
        num_multistarts=4, max_num_steps=6, max_num_restarts=1,
        num_steps_averaged=2, gamma=0.7, pre_mult=1.0,
        max_relative_change=0.5)
    cache = model.program_cache
    results, builds = [], []
    for _ in range(2):
        start = programs.build_count()
        results.append(tei.heuristic_expected_improvement_optimization(
            model.generator, member, dom, 3, params,
            program_cache=cache).numpy())
        builds.append(programs.build_count() - start)
    for _ in range(2):
        start = programs.build_count()
        model.optimize(num_restarts=3)
        builds.append(programs.build_count() - start)
        results += [np.asarray(model.hypers), model.map_values.numpy()]
    return results, builds, _replays_by_kind(cache)


def test_heuristic_refit_and_map_fit_programs_equal_never(monkeypatch):
    """Heuristic q-EI's refit (one program over the padded data, q + 1 = 4
    calls per run) and each round's analytic-EI GD step, and the MAP fit's
    Newton run (one program over (start, data), one call per start): built
    in the first call, none in the second, and every result equal to
    CAPTURE = "never" bit for bit."""
    got, builds, replays = _heuristic_and_map("auto", monkeypatch)
    assert builds[1] == 0 and builds[3] == 0, builds
    assert builds[0] >= 2 and builds[2] == 2, builds
    assert replays["heuristic_refit"] == 8 and replays["map_newton"] == 6
    assert replays["ei_step"] > 0
    ref, never_builds, _ = _heuristic_and_map("never", monkeypatch)
    assert never_builds == [0] * 4
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)


def test_program_cache_counts_builds_and_replays():
    cache = programs.ProgramCache()
    start = programs.build_count()
    prog = cache.get(("a",), lambda t: (t + 1, None))
    assert cache.get(("a",), lambda t: t) is prog
    out, none = prog(torch.zeros(2))
    assert torch.equal(out, torch.ones(2)) and none is None
    prog(torch.ones(2))
    cache.get(("b",), lambda t: t)(torch.zeros(1))
    assert programs.build_count() - start == 2 and prog.replays == 2
    assert len(cache) == 2


def test_launch_counters_set_and_add():
    """Launches add to the registry's ``kernels.<name>`` counters, and a
    reader takes their growth from a snapshot: counters that did not move
    are not in it."""
    before = lu.counters()
    lu.count("kernels.lml_fused", 3)
    lu.count("kernels.descent_run", 2)
    lu.count("kernels.lml_fused")
    counts = _launches(before)
    assert counts["lml_fused"] == 4 and counts["descent_run"] == 2
    assert lu.growth(before) == {"kernels.lml_fused": 4,
                                 "kernels.descent_run": 2}
    now = lu.counters()
    assert lu.growth(now) == {}


SWITCHES = {
    "lml": (tmcmc, "LML_PALLAS",
            lambda: tmcmc.uses_lml_kernel("cuda", torch.float32, (), 512)),
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


PES_KINDS = {"chain_5", "x_star_step", "ep_step", "pes_acquisition_grid",
             "pes_acquisition_step", "pes_recommend_grid",
             "pes_recommend_step"}


def _pes_runs(capture, monkeypatch, tmp_path, device="cpu",
              dtype=torch.float64, **kw):
    """Two ``run_PES`` iterations (d 2, 6 sets, burn-in 9: three 5-step
    chain segments) with ``CAPTURE`` = ``capture``: the history, the builds
    of the run, and the artifacts."""
    from cornell_moe_tpu_torch.acquisition import pes_driver
    monkeypatch.setattr(programs, "CAPTURE", capture)
    out = tmp_path / capture
    out.mkdir()
    start = programs.build_count()
    history = pes_driver.run_PES(
        lambda p: float(np.sum((np.asarray(p) - 0.3) ** 2)), [0.0] * 2,
        [1.0] * 2, 2, **dict(dict(
            number_of_hyperparameter_sets=6, number_of_burnin=9,
            number_of_initial_points=4, number_of_iterations=2,
            gridsize=30, seed=0, verbose=False), **kw),
        output_dir=str(out), device=device, dtype=dtype)
    artifacts = [np.loadtxt(out / name) for name in
                 ("Xsamples.txt", "Ysamples.txt", "guesses.txt")]
    return history, programs.build_count() - start, artifacts


def _assert_pes_equal(got, ref):
    for h, r in zip(got[0], ref[0]):
        for k in ("suggested", "value", "recommended", "best_so_far"):
            np.testing.assert_array_equal(np.asarray(h[k]), np.asarray(r[k]))
    for a, b in zip(got[2], ref[2]):
        np.testing.assert_array_equal(a, b)


def test_pes_iteration_builds_its_programs_after_each_release(
        monkeypatch, tmp_path):
    """``run_PES`` owns one program cache and releases it at the start of
    every iteration (one more observation each): both iterations build
    the same seven kinds, one program each (the chain's 5-step segment,
    replayed three times, the x*
    polish step, EP's sweep, the acquisition's grid and step, the
    recommendation's grid and step), and replay the steps as often as
    their schedules run (x*: 80 steps x 2 rounds; EP: 60 sweeps; each
    polish: 60 steps x 2 rounds).  The run equals its CAPTURE = "never"
    twin bit for bit (history and artifacts), which builds nothing."""
    got = _pes_runs("auto", monkeypatch, tmp_path)
    expected = {k: {"builds": 1, "replays": 1} for k in PES_KINDS}
    expected.update({"chain_5": {"builds": 1, "replays": 3},
                     "x_star_step": {"builds": 1, "replays": 160},
                     "ep_step": {"builds": 1, "replays": 60},
                     "pes_acquisition_step": {"builds": 1, "replays": 120},
                     "pes_recommend_step": {"builds": 1, "replays": 120}})
    assert [h["programs"] for h in got[0]] == [expected, expected]
    assert got[1] == 2 * len(PES_KINDS)
    ref = _pes_runs("never", monkeypatch, tmp_path)
    assert ref[1] == 0 and all(h["programs"] == {} for h in ref[0])
    _assert_pes_equal(got, ref)


def _compat_flow(capture, monkeypatch, device="cpu", dtype=F64, n=12):
    """The compat class flow at a small size: a two-member
    ``GaussianProcessMCMC``, the KG multistart (q = 2) and its VOI, KG and
    EI point lists, the posterior-mean polish by ``GradientDescentOptimizer``
    and a Newton polish, each twice; the results, the builds of each pass
    and the replays by kind."""
    from cornell_moe_tpu_torch.compat import domain as dom_c
    from cornell_moe_tpu_torch.compat import expected_improvement_mcmc as eim
    from cornell_moe_tpu_torch.compat import knowledge_gradient_mcmc as kgm
    from cornell_moe_tpu_torch.compat import optimization as opt_c
    from cornell_moe_tpu_torch.utils.geometry import ClosedInterval
    monkeypatch.setattr(programs, "CAPTURE", capture)
    rng = np.random.default_rng(0)
    x = rng.random((n, 2))
    data = HistoricalData(2)
    data.append_historical_data(x, np.sin(3 * x[:, 0]) + x[:, 1] ** 2)
    kw = dict(device=device, dtype=dtype)
    gp_mcmc = kgm.GaussianProcessMCMC([[1.0, 0.3, 0.4], [0.8, 0.5, 0.2]],
                                      [[1e-2], [2e-2]], data, **kw)
    domain = dom_c.TensorProductDomain([ClosedInterval(0.0, 1.0)] * 2, **kw)
    params = optimizers.GradientDescentParameters(
        num_multistarts=6, max_num_steps=5, max_num_restarts=1,
        num_steps_averaged=2, gamma=0.7, pre_mult=1.0,
        max_relative_change=0.5)
    inner = optimizers.GradientDescentParameters(
        num_multistarts=1, max_num_steps=4, max_num_restarts=1,
        num_steps_averaged=0, gamma=0.0, pre_mult=1.0,
        max_relative_change=0.1)
    newton = optimizers.NewtonParameters(max_num_steps=5)
    blocks = rng.random((3, 2, 2))
    results, builds = [], []
    for _ in range(2):
        start = programs.build_count()
        kg_obj = kgm.KnowledgeGradientMCMC(
            gp_mcmc, inner_optimizer=inner,
            discrete_pts_list=[x[:4], x[4:8]], num_to_sample=2,
            num_mc_iterations=8, generator=3)
        picks = kgm.multistart_knowledge_gradient_mcmc_optimization(
            opt_c.GradientDescentOptimizer(domain, kg_obj, params),
            generator=torch.Generator(device=device).manual_seed(1))
        kg_obj.set_current_point(picks)
        ei_obj = eim.ExpectedImprovementMCMC(gp_mcmc, num_to_sample=2,
                                             num_mc_iterations=16)
        ps = kgm.PosteriorMeanMCMC(gp_mcmc)
        ps.set_current_point(x[0])
        rec = opt_c.GradientDescentOptimizer(domain, ps, params).optimize()
        ps.set_current_point(x[1])
        polished = opt_c.NewtonOptimizer(domain, ps, newton).optimize()
        results += [picks, kg_obj.compute_knowledge_gradient_mcmc(),
                    kg_obj.evaluate_at_point_list(blocks),
                    ei_obj.evaluate_at_point_list(blocks), rec, polished]
        builds.append(programs.build_count() - start)
    return results, builds, _replays_by_kind(gp_mcmc.program_cache)


COMPAT_KINDS = {"fit", "kg_score", "ei_mcmc_point", "compat_step",
                "compat_newton"}


def test_compat_flow_programs_equal_never(monkeypatch):
    """``GaussianProcessMCMC`` owns the cache its objectives share: its
    fit, the KG point list's scoring (``kg_score``, one program per block
    shape), EI's point list (``ei_mcmc_point``, one program per block
    shape), the posterior-mean polish's GD step and the Newton run
    are built in the first pass and only replayed in the second, and every
    result equals CAPTURE = "never" bit for bit.  The KG multistart and
    the single VOI stay eager by their rule (no ``kg_cold`` or
    ``kg_warm_step`` program): ungated, the multistart is bound by the
    card's work, and one evaluation cannot repay a build."""
    got, builds, replays = _compat_flow("auto", monkeypatch)
    assert set(replays) == COMPAT_KINDS, replays
    assert replays["kg_score"] == 2 * 3
    assert builds[0] > 0 and builds[1] == 0, builds
    assert replays["compat_step"] == 2 * 5 and replays["compat_newton"] == 2
    assert replays["ei_mcmc_point"] == 2 * 3
    ref, never_builds, never_replays = _compat_flow("never", monkeypatch)
    assert never_builds == [0, 0] and never_replays == {}
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_compat_eager_rules(monkeypatch):
    """``compat.optimization.runs_programs``: an objective with only numpy
    methods reads the host at every step and polishes eagerly; the MC and
    closed-form EI and every torch objective with a cache take their
    steps as programs; under CAPTURE = "never" none does.  Each polish
    equals its eager twin bit for bit."""
    from cornell_moe_tpu_torch.compat import covariance as cov_c
    from cornell_moe_tpu_torch.compat import domain as dom_c
    from cornell_moe_tpu_torch.compat import expected_improvement as ei_c
    from cornell_moe_tpu_torch.compat import gaussian_process as gp_c
    from cornell_moe_tpu_torch.compat import knowledge_gradient as kg_c
    from cornell_moe_tpu_torch.compat import optimization as opt_c
    from cornell_moe_tpu_torch.compat.log_likelihood import \
        GaussianProcessLogMarginalLikelihood
    from cornell_moe_tpu_torch.utils.geometry import ClosedInterval

    rng = np.random.default_rng(0)
    x = rng.random((10, 2))
    data = HistoricalData(2)
    data.append_historical_data(x, np.cos(3 * x[:, 0]) + x[:, 1])
    kw = dict(device="cpu", dtype=F64)
    gp = gp_c.GaussianProcess(cov_c.MaternNu2p5([1.0, 0.3, 0.4], **kw),
                              [1e-2], data)
    domain = dom_c.TensorProductDomain([ClosedInterval(0.0, 1.0)] * 2, **kw)

    class NumpyPosteriorMean:
        """A posterior-mean objective with numpy methods only."""

        def __init__(self):
            self._pm = kg_c.PosteriorMean(gp)
            self.program_cache = programs.ProgramCache()

        def get_current_point(self):
            return self._pm.get_current_point()

        def set_current_point(self, p):
            self._pm.set_current_point(p)

        def compute_objective_function(self):
            return self._pm.compute_objective_function()

        def compute_grad_objective_function(self):
            return self._pm.compute_grad_objective_function()

    objectives = {
        "numpy": NumpyPosteriorMean(),
        "mc_ei": ei_c.ExpectedImprovement(gp, points_to_sample=x[:2],
                                          num_mc_iterations=16),
        "analytic_ei": ei_c.ExpectedImprovement(gp, points_to_sample=x[:1]),
        "posterior_mean": kg_c.PosteriorMean(gp, point_to_sample=x[0]),
        "lml": GaussianProcessLogMarginalLikelihood(
            cov_c.MaternNu2p5([1.0, 0.3, 0.4], **kw), data,
            noise_variance=[1e-2]),
    }
    expected = {"numpy": False, "mc_ei": True, "analytic_ei": True,
                "posterior_mean": True, "lml": True}
    params = optimizers.GradientDescentParameters(
        num_multistarts=1, max_num_steps=4, max_num_restarts=1,
        num_steps_averaged=0, gamma=0.7, pre_mult=0.1,
        max_relative_change=0.5)
    for name, obj in objectives.items():
        monkeypatch.setattr(programs, "CAPTURE", "auto")
        assert opt_c.runs_programs(obj) == expected[name], name
        dom = dom_c.TensorProductDomain(
            [ClosedInterval(0.1, 5.0)] * 3, **kw) if name == "lml" else \
            domain
        start = obj.get_current_point()
        out = []
        for capture in ("auto", "never"):
            monkeypatch.setattr(programs, "CAPTURE", capture)
            obj.set_current_point(start)
            before = programs.build_count()
            out.append(opt_c.GradientDescentOptimizer(dom, obj,
                                                      params).optimize())
            built = programs.build_count() - before
            assert built == int(expected[name] and capture == "auto"), name
            if capture == "never":
                assert not opt_c.runs_programs(obj)
        np.testing.assert_array_equal(out[0], out[1])


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
        before = lu.counters()
        model.train()
        torch.cuda.synchronize()
        out.append((_launches(before), model.chain_steps,
                    model.p0.cpu().numpy(), model.models.chol_K.cpu().numpy(),
                    model.models.K_inv_y.cpu().numpy()))
        if capture == "auto":
            assert {k[0] for k in model.program_cache.programs()} == \
                {"chain", "fit"}
    (counts, *got), (ref_counts, *ref) = out
    assert counts == ref_counts and counts.get("lml_fused", 0) > 0 and \
        counts.get("covariance_with_noise", 0) > 0
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
    draws) with its programs (the seeding q-EI's step and polish step, the
    KG multistart's cold evaluation and warm step with kernel A inside,
    the VOI's scoring) and with CAPTURE = "never": the same
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
        before = lu.counters()
        discrete = tbo.seed_kg_discretization(
            gen, model.models, dom, qei_params=params, num_qei_pts=3,
            num_mc=64, conv_tol=3e-3, program_cache=cache)
        pts, voi = tbo._qkg_suggest_arrays(
            gen, model.models, dom, discrete, params,
            tbo.DEFAULT_SGD_PARAMS_PS, 2, 32, conv_tol=3e-3,
            program_cache=cache)
        torch.cuda.synchronize()
        out.append((discrete.cpu().numpy(), pts.cpu().numpy(),
                    voi.cpu().numpy(), _launches(before)))
        kinds = {k[0]: p.replays for k, p in cache.programs().items()}
        if capture == "auto":
            assert set(kinds) == SUGGEST_KG
            assert all(v > 0 for v in kinds.values())
        else:
            assert not kinds
    (*got, counts), (*ref, ref_counts) = out
    assert counts == ref_counts and counts.get("descent_run", 0) > 2
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("method, objective", [
    ("EI", "Branin"), ("KG", "BraninFidelity")])
def test_captured_driver_iteration_equals_eager(dev, monkeypatch, method,
                                                objective):
    """Two iterations of method "EI" (its GD step and scoring programs) and
    of cf-KG (its warm step a program since the fidelity cost reads nothing
    from the host) at a reduced width on the card, float32, with programs
    and with CAPTURE = "never": points, VOIs, recommendations and
    launches bit for bit; the second iteration builds nothing."""
    fast = optimizers.GradientDescentParameters(
        num_multistarts=40, max_num_steps=20, max_num_restarts=2,
        num_steps_averaged=4, gamma=0.7, pre_mult=1.0,
        max_relative_change=0.5, tolerance=1e-10)
    out = []
    for capture in ("auto", "never"):
        monkeypatch.setattr(programs, "CAPTURE", capture)
        bo = tbo.BayesianOptimizer(
            objective_func=getattr(tsf, objective)(), method=method,
            num_to_sample=2, num_mc=32, n_hypers=8, chain_length=128,
            burnin_steps=128, noisy=True, standardize=True, sgd_params=fast,
            device=dev, dtype=torch.float32, verbose=False)
        before = lu.counters()
        builds = []
        for it in range(2):
            start = programs.build_count()
            bo.run(it + 1, num_init_pts=100, start_iteration=it)
            builds.append(programs.build_count() - start)
        torch.cuda.synchronize()
        out.append(([(h["suggested"], h["voi"], h["recommended"])
                     for h in bo.history], _launches(before)))
        if capture == "auto":
            assert builds[0] > 0 and builds[1] == 0, builds
            assert all(p.replays > 1
                       for k, p in bo.program_cache.programs().items()
                       if k[0] != "chain"), bo.program_cache.programs()
    (got, counts), (ref, ref_counts) = out
    assert counts == ref_counts
    for g, r in zip(got, ref):
        for a, b in zip(g, r):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.cuda
def test_captured_heuristic_and_map_equal_eager(dev, monkeypatch):
    """Heuristic q-EI (q = 3; its refit and each round's GD step as
    programs) on member 0 and the MAP fit (each start's Newton run one
    program) of a trained float32 model on the card, against CAPTURE =
    "never" from the same generator state: picks, ends and the chosen
    hyperparameters bit for bit."""
    from cornell_moe_tpu_torch.acquisition import expected_improvement as tei
    model = _card_model(dev)
    model.train()
    dom = tbo.TensorProductDomain.from_bounds([[0, 1], [0, 1]], device=dev,
                                              dtype=torch.float32)
    member = model.models.member(0)
    state = model.generator.get_state()
    out = []
    for capture in ("auto", "never"):
        monkeypatch.setattr(programs, "CAPTURE", capture)
        model.generator.set_state(state)
        picks = tei.heuristic_expected_improvement_optimization(
            model.generator, member, dom, 3, tbo.DEFAULT_SGD_PARAMS_KG,
            program_cache=model.program_cache)
        model.optimize(num_restarts=3)
        torch.cuda.synchronize()
        out.append((picks.cpu().numpy(), np.asarray(model.hypers),
                    model.map_values.cpu().numpy()))
    replays = _replays_by_kind(model.program_cache)
    assert replays["heuristic_refit"] == 4 and replays["map_newton"] == 3
    for a, b in zip(*out):
        np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
def test_nccl_world_of_one_captures_chain_and_recommend(dev, monkeypatch):
    """Under an NCCL world of one the chain's segments and the
    recommendation's grid run as CUDA graphs with their all_gather
    captured inside: the walkers, the ensemble and the recommendation
    equal the unsharded eager run (CAPTURE = "never") bit for bit.  The
    graphs are freed before the group is destroyed."""
    from cornell_moe_tpu_torch.parallel import sharding
    guesses = torch.rand(500, 2, device=dev,
                         generator=torch.Generator(device=dev).manual_seed(1))
    dom = tbo.TensorProductDomain.from_bounds([[0, 1], [0, 1]], device=dev,
                                              dtype=torch.float32)
    out = []
    for capture, sharded in (("auto", True), ("never", False)):
        monkeypatch.setattr(programs, "CAPTURE", capture)
        group = sharding.default_process_group(1) if sharded else None
        try:
            model = _card_model(dev)
            model.process_group = group
            model.train()
            rec = tbo.recommend_from_guesses(
                model.models, dom, guesses, group=group,
                program_cache=model.program_cache)
            torch.cuda.synchronize()
            out.append((model.p0.cpu().numpy(),
                        model.models.chol_K.cpu().numpy(), rec.cpu().numpy(),
                        model.chain_steps))
            if sharded:
                replays = _replays_by_kind(model.program_cache)
                assert replays["chain"] > 0 and \
                    replays["recommend_grid"] == 1, replays
        finally:
            model.program_cache.release()
            if sharded:
                dist.destroy_process_group()
    for a, b in zip(*out):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.cuda
def test_capture_holds_off_the_garbage_collector(dev):
    """A cache dropped without ``release()`` lives on in a reference cycle
    (each program holds its cache) until the garbage collector finds it,
    and a graph destroyed while another is being captured invalidates that
    capture: Python's automatic collection is off while a program is
    captured (not during its warm-up call), and on again after."""
    import gc
    seen = []

    def fn(t):
        seen.append(gc.isenabled())
        return t * 2

    x = torch.ones(4, device=dev)
    out = programs.ProgramCache().get(("gc",), fn)(x)
    torch.cuda.synchronize()
    assert torch.equal(out, x * 2)
    assert seen == [True, False] and gc.isenabled()


@pytest.mark.cuda
def test_replay_keeps_earlier_outputs(dev):
    """A fitted ensemble handed back by the fit's program stays as it was
    when the program replays for other hyperparameters, and each replay
    adds the capture's launches of kernel C; so do the factors of heuristic
    q-EI's refit program when it replays for other hyperparameters."""
    cache = programs.ProgramCache()
    rng = np.random.default_rng(0)
    x, y = rng.random((64, 2)), rng.standard_normal(64)
    kw = dict(device=dev, dtype=torch.float32)

    def fit(scale):
        h = torch.tensor([[1.0, 0.3 * scale, 0.4]] * 4, **kw)
        return tmcmc.fit_gp_ensemble("matern_2.5", h,
                                     torch.full((4, 1), 1e-2, **kw), x, y,
                                     bucket=16, program_cache=cache)

    before = lu.counters()
    first = fit(1.0)
    kept = first.chol_K.clone()
    second = fit(2.0)
    torch.cuda.synchronize()
    assert torch.equal(first.chol_K, kept)
    assert not torch.equal(first.chol_K, second.chol_K)
    assert _launches(before).get("covariance_with_noise", 0) == 2
    prog, = cache.programs().values()
    assert prog.launch_growth == {"kernels.covariance_with_noise": 1}

    from cornell_moe_tpu_torch.models import gp as tgp
    matern = tcov.COVARIANCE_TYPES["matern_2.5"]

    def refit(hypers):
        return programs.run(
            cache, ("heuristic_refit",),
            lambda h, nv, xx, yy: tgp.fit_factors(
                matern(hyperparameters=h), nv, xx, yy, None, ()),
            hypers, torch.full((1,), 1e-2, **kw), torch.as_tensor(x, **kw),
            torch.as_tensor(y[:, None], **kw))

    chol, k_inv_y, _, _ = refit(torch.tensor([1.0, 0.3, 0.4], **kw))
    kept = chol.clone(), k_inv_y.clone()
    again = refit(torch.tensor([2.0, 0.5, 0.2], **kw))
    torch.cuda.synchronize()
    assert torch.equal(chol, kept[0]) and torch.equal(k_inv_y, kept[1])
    assert not torch.equal(chol, again[0])
    assert _replays_by_kind(cache)["heuristic_refit"] == 2


@pytest.mark.cuda
def test_captured_pes_iterations_equal_never(dev, monkeypatch, tmp_path):
    """Two ``run_PES`` iterations in float32 on the card (d 2, 6 sets) with
    their programs captured as CUDA graphs, against CAPTURE = "never":
    history and artifacts bit for bit, and every kind built in both
    iterations."""
    got = _pes_runs("auto", monkeypatch, tmp_path, device=dev,
                    dtype=torch.float32)
    assert all(set(h["programs"]) == PES_KINDS for h in got[0])
    ref = _pes_runs("never", monkeypatch, tmp_path, device=dev,
                    dtype=torch.float32)
    _assert_pes_equal(got, ref)


@pytest.mark.cuda
def test_captured_compat_flow_equals_never(dev, monkeypatch):
    """The compat flow of :func:`_compat_flow` in float32 on the card
    (n 64) with its programs captured, against CAPTURE = "never": every
    result bit for bit, nothing built in the second pass."""
    got, builds, replays = _compat_flow("auto", monkeypatch, device=dev,
                                        dtype=torch.float32, n=64)
    assert set(replays) == COMPAT_KINDS and builds[1] == 0
    ref, _, _ = _compat_flow("never", monkeypatch, device=dev,
                             dtype=torch.float32, n=64)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
