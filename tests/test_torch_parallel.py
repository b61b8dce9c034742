"""The port's scale-out (``cornell_moe_tpu_torch.parallel``) on gloo
process groups of 2 and 4 ranks spawned on the CPU, against unsharded runs.

The counterpart of ``tests/test_parallel.py``, which holds the JAX
package's mesh to a single device: every sharded run here must equal the
unsharded run of the same inputs, at that file's tolerances: rtol 1e-12
for the multistarts and the chain step, 1e-11 for the points and hypers of
one driver iteration, 1e-9 for its recommendation.  The unsharded
multistarts are held to the JAX package's on the same numpy inputs at the
tolerances of ``tests/test_torch_kg.py`` and ``tests/test_torch_driver.py``
(the KG ones at rtol 1e-7, as the warm multistart of the slice test); the
stretch-move step is held to JAX's in ``tests/test_torch_mcmc.py``.  A
driver iteration draws from ``torch.Generator``s, which JAX cannot share,
so it is held only to the unsharded driver.

Each test spawns one group (``parallel.spawn.run_process_group``: a
``FileStore`` under ``tmp_path``, a time limit per group, a rank's
exception re-raised here) and runs several checks in it.  The ranks run
this file's ``_*_rank`` functions; JAX is imported inside the tests only,
so the ranks import torch alone.
"""

import numpy as np
import pytest
import torch

from cornell_moe_tpu_torch import bayes_opt as tbo
from cornell_moe_tpu_torch.acquisition import knowledge_gradient as tkg
from cornell_moe_tpu_torch.models import mcmc as tmcmc
from cornell_moe_tpu_torch.ops import optimizers as topt
from cornell_moe_tpu_torch.ops.domains import RepeatedDomain as TRep
from cornell_moe_tpu_torch.ops.domains import TensorProductDomain as TDom
from cornell_moe_tpu_torch.parallel import sharding, spawn
from cornell_moe_tpu_torch.utils.synthetic_functions import Branin

torch.set_num_threads(1)
SHARD = dict(rtol=1e-12, atol=0.0)
KG_TOL = dict(rtol=1e-7, atol=1e-9)
GROUP_TIMEOUT_S = 240.0
WORLDS = pytest.mark.parametrize("world", [2, 4])

QUAD = dict(num_multistarts=16, max_num_steps=80, max_num_restarts=2,
            gamma=0.6, pre_mult=0.4)
QUAD_PAD = dict(num_multistarts=13, max_num_steps=50, max_num_restarts=1,
                gamma=0.6, pre_mult=0.4)
# tests/test_parallel.py:108 and :160
KG_N, KG_D, KG_S, KG_Q, KG_M, KG_STARTS = 14, 2, 4, 2, 8, 16
KG_BATCHED = dict(num_multistarts=16, max_num_steps=3, max_num_restarts=1,
                  gamma=0.7, pre_mult=0.3, max_relative_change=0.5)
KG_WARM = dict(num_multistarts=16, max_num_steps=6, max_num_restarts=2,
               num_steps_averaged=3, gamma=0.7, pre_mult=0.3,
               max_relative_change=0.5)
KG_INNER = dict(num_multistarts=1, max_num_steps=3, max_num_restarts=1,
                num_steps_averaged=2, gamma=0.0, pre_mult=1.0,
                max_relative_change=0.1)
KG_INNER_WARM = dict(KG_INNER, max_num_steps=1, num_steps_averaged=0)
# the per-start route: fewer starts (each its own trajectory)
KG_PER_START = dict(KG_BATCHED, num_multistarts=8)
# tests/test_parallel.py:225-301
DRIVER_SGD = dict(num_multistarts=8, max_num_steps=6, max_num_restarts=1,
                  num_steps_averaged=3, gamma=0.7, pre_mult=1.0,
                  max_relative_change=0.5, tolerance=1e-10)


def _t(a):
    return torch.as_tensor(np.array(a), dtype=torch.float64)


def _run_group(tmp_path, world, fn, *args):
    return spawn.run_process_group(
        fn, world, str(tmp_path / f"store_{fn.__name__}_{world}"),
        args=args, timeout_s=GROUP_TIMEOUT_S)


def _numpy(res):
    return {k: v.numpy() for k, v in res._asdict().items()}


# ---------------------------------------------------------------------------
# the multistarts, point evaluation and the chain step on a quadratic
# ---------------------------------------------------------------------------

def _quad_vg(target):
    def vg(x):
        return -torch.sum((x - target) ** 2), -2.0 * (x - target)
    return vg


def _quad_bvg(target):
    def bvg(x):
        return -torch.sum((x - target) ** 2, dim=(1, 2)), -2.0 * (x - target)
    return bvg


def _gaussian_lp(p):
    return -0.5 * torch.sum(p * p * _t([1.0, 4.0, 0.25]), dim=1)


def _quadratic_runs(data, group):
    """Every quadratic check, sharded over ``group`` or unsharded (None)."""
    dom2 = TDom.from_bounds([[-2.0, 2.0], [-2.0, 2.0]])
    dom1 = TDom.from_bounds([[-1.0, 1.0]])
    rep = TRep(domain=dom2, num_repeats=1)
    vg = _quad_vg(_t([0.3, -0.7]))
    bvg = _quad_bvg(_t([0.3, -0.7]))
    starts, starts13 = _t(data["starts"]), _t(data["starts13"])
    per_start = topt.GradientDescentParameters(**QUAD)
    pad = topt.GradientDescentParameters(**QUAD_PAD)
    gated = dict(chunk_size=2, conv_tol=1e-3)
    pts = _t(data["points"])

    def f(p):
        return -torch.sum(p ** 2, dim=1)

    if group is None:
        out = {
            "per_start": topt.multistart_optimize(vg, dom2, starts,
                                                  per_start),
            "padded": topt.multistart_optimize(_quad_vg(_t([0.5])), dom1,
                                               starts13, pad),
            "batched": topt.multistart_optimize_batched(
                bvg, rep, starts[:, None], per_start),
            "gated": topt.multistart_optimize_batched(
                bvg, rep, starts[:, None], per_start, **gated)}
        values = f(pts)
        step = tmcmc.stretch_move_step
    else:
        out = {
            "per_start": sharding.sharded_multistart_optimize(
                vg, dom2, starts, per_start, group),
            "padded": sharding.sharded_multistart_optimize(
                _quad_vg(_t([0.5])), dom1, starts13, pad, group),
            "batched": sharding.sharded_multistart_optimize_batched(
                bvg, rep, starts[:, None], per_start, group),
            "gated": sharding.sharded_multistart_optimize_batched_gated(
                bvg, rep, starts[:, None], per_start, group, **gated)}
        values = sharding.sharded_point_evaluation(f, pts, group)
        step = sharding.sharded_ensemble_mcmc_step(_gaussian_lp, group)
    out = {k: _numpy(v) for k, v in out.items()}
    out["point_values"] = values.numpy()
    gen = torch.Generator().manual_seed(5)
    pos = _t(data["walkers"])
    lp = _gaussian_lp(pos)
    for _ in range(3):
        if group is None:
            pos, lp = step(gen, pos, lp, _gaussian_lp)
        else:
            pos, lp = step(gen, pos, lp)
    out["chain"] = {"positions": pos.numpy(), "log_probs": lp.numpy()}
    return out


def _quadratic_rank(data):
    torch.set_num_threads(1)
    return _quadratic_runs(data, torch.distributed.group.WORLD)


@pytest.fixture
def quad_data(rng):
    return {"starts": rng.uniform(-2.0, 2.0, (16, 2)),
            "starts13": rng.uniform(-1.0, 1.0, (13, 1)),
            "points": np.linspace(-1.0, 1.0, 37)[:, None],
            "walkers": rng.standard_normal((8, 3))}


def test_pad_to_multiple_is_edge_padding(rng):
    import jax.numpy as jnp

    from cornell_moe_tpu.parallel import sharding as jshard
    x = rng.standard_normal((13, 2, 3))
    for multiple in (1, 2, 4, 13):
        got, n = sharding.pad_to_multiple(_t(x), multiple)
        ref, n_ref = jshard.pad_to_multiple(jnp.asarray(x), multiple)
        assert n == n_ref == 13
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@WORLDS
def test_sharded_quadratic_runs_equal_unsharded(tmp_path, quad_data,
                                                world):
    """Per-start multistart (16 starts; 13 with edge padding), the batched
    and the gated batched multistart, point evaluation (37 points) and three
    stretch-move steps with walkers sharded: every rank equal to the
    unsharded run at rtol 1e-12."""
    single = _quadratic_runs(quad_data, None)
    ranks = _run_group(tmp_path, world, _quadratic_rank, quad_data)
    assert ranks[0]["padded"]["all_points"].shape == (13, 1)
    for got in ranks:
        for name, ref in single.items():
            if isinstance(ref, dict):
                for k in ref:
                    np.testing.assert_allclose(got[name][k], ref[k],
                                               err_msg=f"{name}.{k}",
                                               **SHARD)
            else:
                np.testing.assert_allclose(got[name], ref, **SHARD)


def test_unsharded_quadratic_multistart_matches_jax(quad_data):
    import jax
    import jax.numpy as jnp

    from cornell_moe_tpu.ops import optimizers as jopt
    from cornell_moe_tpu.ops.domains import TensorProductDomain as JDom

    target = jnp.asarray([0.3, -0.7])

    def vg(x):
        return -jnp.sum((x - target) ** 2), -2.0 * (x - target)

    dom = JDom.from_bounds([[-2.0, 2.0], [-2.0, 2.0]])
    ref = jopt.multistart_optimize(
        vg, dom, jnp.asarray(quad_data["starts"]),
        jopt.GradientDescentParameters(**QUAD))
    got = _quadratic_runs(quad_data, None)
    np.testing.assert_allclose(got["per_start"]["all_points"],
                               np.asarray(ref.all_points), **KG_TOL)
    np.testing.assert_allclose(got["point_values"], np.asarray(
        jax.vmap(lambda p: -jnp.sum(p ** 2))(
            jnp.asarray(quad_data["points"]))), **SHARD)


# ---------------------------------------------------------------------------
# the KG multistarts (tests/test_parallel.py:108 and :160)
# ---------------------------------------------------------------------------

@pytest.fixture
def kg_data(rng):
    x = rng.random((KG_N, KG_D))
    return {"x": x, "y": np.sin(3 * x[:, 0]) + x[:, 1] ** 2,
            "hypers": np.abs(rng.standard_normal((KG_S, 1 + KG_D))) + 0.7,
            "noises": np.full((KG_S, 1), 1e-3),
            "discrete": rng.random((KG_S, 5, KG_D)),
            "normals": rng.standard_normal((KG_M, KG_Q)),
            "starts": rng.random((KG_STARTS, KG_Q, KG_D))}


def _kg_setup(data):
    states = tmcmc.fit_gp_ensemble(
        "matern_2.5", _t(data["hypers"]), _t(data["noises"]), data["x"],
        data["y"][:, None])
    dom = TDom.from_bounds([[0.0, 1.0]] * KG_D)
    disc, normals = _t(data["discrete"]), _t(data["normals"])
    bsf = torch.full((KG_S,), float(data["y"].min()), dtype=torch.float64)
    inner = topt.GradientDescentParameters(**KG_INNER)
    inner_warm = topt.GradientDescentParameters(**KG_INNER_WARM)

    def bvg_cold(u):
        return tkg.knowledge_gradient_mcmc_batch_vg_carry(
            states, u, disc, normals, dom, inner, bsf)

    def bvg_warm(u, carry):
        return tkg.knowledge_gradient_mcmc_batch_vg_carry(
            states, u, disc, normals, dom, inner_warm, bsf, inner_x0=carry)

    return states, dom, disc, inner, bvg_cold, bvg_warm


def _kg_runs(data, group, world):
    """The KG multistarts over ``group``'s ranks, or unsharded (None) with
    the chunking of a world of ``world`` ranks."""
    states, dom, disc, inner, bvg_cold, bvg_warm = _kg_setup(data)
    rep = TRep(domain=dom, num_repeats=KG_Q)
    starts = _t(data["starts"])
    batched = topt.GradientDescentParameters(**KG_BATCHED)
    warm = topt.GradientDescentParameters(**KG_WARM)
    chunk = KG_STARTS // world
    if group is None:
        out = {"batched": topt.multistart_optimize_batched(
                   lambda u: bvg_cold(u)[:2], rep, starts, batched),
               "warm": topt.multistart_optimize_batched_warm(
                   bvg_cold, bvg_warm, rep, starts, warm, chunk_size=2,
                   conv_tol=3e-3)}
    else:
        out = {"batched": sharding.sharded_multistart_optimize_batched(
                   lambda u: bvg_cold(u)[:2], rep, starts, batched, group),
               "warm": sharding.sharded_multistart_optimize_batched_warm(
                   bvg_cold, bvg_warm, rep, starts, warm, group,
                   chunk_size=2, conv_tol=3e-3)}
    out = {k: _numpy(v) for k, v in out.items()}
    routes = {"warm_route": (warm, dict(use_batched=True, warm_start=True,
                                        chunk_size=chunk, conv_tol=3e-3)),
              "batched_route": (batched, dict(use_batched=True,
                                              warm_start=False,
                                              chunk_size=chunk)),
              "per_start_route": (topt.GradientDescentParameters(
                  **KG_PER_START), dict(use_batched=False))}
    for name, (params, kw) in routes.items():
        out[name] = tkg.multistart_knowledge_gradient_mcmc_optimization(
            torch.Generator().manual_seed(11), states, dom, KG_Q, params,
            inner, disc, num_mc_iterations=KG_M, group=group,
            **kw).numpy()
    return out


def _kg_rank(data, world):
    torch.set_num_threads(1)
    return _kg_runs(data, torch.distributed.group.WORLD, world)


@WORLDS
def test_sharded_kg_multistarts_equal_unsharded(tmp_path, kg_data, world):
    """The batched (:108) and warm gated (:160, chunk 2) KG multistarts,
    and the three routes of ``multistart_knowledge_gradient_mcmc_
    optimization`` (warm and batched with the chunk matched to the
    per-rank shard, per-start), sharded over 2 and 4 ranks: equal to the
    unsharded runs at rtol 1e-12."""
    single = _kg_runs(kg_data, None, world)
    for got in _run_group(tmp_path, world, _kg_rank, kg_data, world):
        for name, ref in single.items():
            if isinstance(ref, dict):
                for k in ref:
                    np.testing.assert_allclose(got[name][k], ref[k],
                                               err_msg=f"{name}.{k}",
                                               **SHARD)
            else:
                np.testing.assert_allclose(got[name], ref, err_msg=name,
                                           **SHARD)


def test_unsharded_kg_multistarts_match_jax(kg_data):
    """The unsharded batched and warm gated KG multistarts against the JAX
    package's on the same numpy inputs (rtol 1e-7)."""
    import jax
    import jax.numpy as jnp

    from cornell_moe_tpu.acquisition import knowledge_gradient as jkg
    from cornell_moe_tpu.models import mcmc as jmcmc
    from cornell_moe_tpu.ops import optimizers as jopt
    from cornell_moe_tpu.ops.domains import RepeatedDomain as JRep
    from cornell_moe_tpu.ops.domains import TensorProductDomain as JDom

    d = kg_data
    states = jmcmc.fit_gp_ensemble(
        "matern_2.5", jnp.asarray(d["hypers"]), jnp.asarray(d["noises"]),
        jnp.asarray(d["x"]), jnp.asarray(d["y"])[:, None])
    dom = JDom.from_bounds([[0.0, 1.0]] * KG_D)
    rep = JRep(domain=dom, num_repeats=KG_Q)
    disc, normals = jnp.asarray(d["discrete"]), jnp.asarray(d["normals"])
    bsf = jnp.full((KG_S,), float(d["y"].min()))
    inner = jopt.GradientDescentParameters(**KG_INNER)
    inner_warm = jopt.GradientDescentParameters(**KG_INNER_WARM)
    starts = jnp.asarray(d["starts"])

    def bvg(u):
        return jkg.knowledge_gradient_mcmc_batch_value_and_grad(
            states, u, disc, normals, dom, inner, bsf, KG_Q)

    def bvg_cold(u):
        return jkg.knowledge_gradient_mcmc_batch_vg_carry(
            states, u, disc, normals, dom, inner, bsf, KG_Q)

    def bvg_warm(u, carry):
        return jkg.knowledge_gradient_mcmc_batch_vg_carry(
            states, u, disc, normals, dom, inner_warm, bsf, KG_Q,
            inner_x0=carry, warm_mode="reseed")

    ref = {"batched": jax.jit(lambda st: jopt.multistart_optimize_batched(
               bvg, rep, st, jopt.GradientDescentParameters(
                   **KG_BATCHED)))(starts),
           "warm": jax.jit(lambda st: jopt.multistart_optimize_batched_warm(
               bvg_cold, bvg_warm, rep, st,
               jopt.GradientDescentParameters(**KG_WARM), chunk_size=2,
               conv_tol=3e-3))(starts)}
    got = _kg_runs(kg_data, None, 1)
    for name, r in ref.items():
        np.testing.assert_allclose(got[name]["all_values"],
                                   np.asarray(r.all_values), **KG_TOL)
        np.testing.assert_allclose(got[name]["all_points"],
                                   np.asarray(r.all_points), **KG_TOL)


# ---------------------------------------------------------------------------
# the chain's segment programs with their gather inside
# ---------------------------------------------------------------------------

def _group_chain(group, capture):
    """A gated chain (8 walkers: a 70-step burn-in, one 64-step segment and
    a 6-step remainder, then segments of 64 to the gate) on 20 points,
    float64, under ``group`` (None: unsharded) with ``programs.CAPTURE`` =
    ``capture``: the walkers, the chain's steps and the program kinds."""
    from cornell_moe_tpu_torch.ops import programs
    from cornell_moe_tpu_torch.utils.data_containers import HistoricalData

    rng = np.random.default_rng(0)
    x = rng.random((20, 2))
    data = HistoricalData(2)
    data.append_historical_data(x, np.sin(3 * x[:, 0]) + x[:, 1] ** 2)
    model = tmcmc.GaussianProcessLogLikelihoodMCMC(
        data, n_hypers=8, noisy=True, bucket=16, chain_gate_tol=1.0,
        burnin_steps=70, chain_length=200, device="cpu",
        generator=torch.Generator().manual_seed(3), process_group=group)
    saved, programs.CAPTURE = programs.CAPTURE, capture
    try:
        model.train()
    finally:
        programs.CAPTURE = saved
    return {"walkers": model.p0.numpy(), "chain_steps": model.chain_steps,
            "kinds": sorted({k[0] for k in model.program_cache.programs()})}


def _chain_rank():
    torch.set_num_threads(1)
    group = torch.distributed.group.WORLD
    return {c: _group_chain(group, c) for c in ("auto", "never")}


def test_chain_segments_on_a_group_equal_unsharded(tmp_path):
    """On 2 ranks the chain runs as segment programs, each half-step's
    walker blocks gathered inside the program (on the CPU a program calls
    its function; on a card an NCCL gather is captured with it): the
    walkers and the chain's steps equal the step-by-step sharded chain
    (``CAPTURE = "never"``) and the unsharded run bit for bit, on both
    ranks."""
    single = _group_chain(None, "auto")
    assert single["kinds"] == ["chain", "fit"]
    for got in _run_group(tmp_path, 2, _chain_rank):
        assert got["auto"]["kinds"] == ["chain", "fit"]
        assert got["never"]["kinds"] == []
        for run in (got["auto"], got["never"]):
            np.testing.assert_array_equal(run["walkers"], single["walkers"])
            assert run["chain_steps"] == single["chain_steps"]


# ---------------------------------------------------------------------------
# the driver: one iteration, and checkpoint and resume
# ---------------------------------------------------------------------------

def _driver(method, group=None, **kw):
    return tbo.BayesianOptimizer(**dict(dict(
        objective_func=Branin(), method=method, num_to_sample=2,
        num_mc=16 if method == "KG" else 32, n_hypers=8, chain_length=20,
        burnin_steps=20, noisy=False,
        sgd_params=topt.GradientDescentParameters(**DRIVER_SGD), seed=7,
        verbose=False, shape_bucket=8, suggest_chunk_size=1, device="cpu",
        process_group=group), **kw))


def _iteration(method, group):
    """tests/test_parallel.py:225-301: initialize on 6 points, suggest,
    observe, recommend."""
    bo = _driver(method, group)
    bo.initialize(num_init_pts=6)
    hypers = np.array(bo.model.hypers)
    pts, voi = bo.suggest()
    bo.observe(pts)
    return {"hypers": hypers, "suggested": pts, "voi": voi,
            "recommended": bo.recommend(),
            "chain_steps": bo.model.chain_steps}


def _iteration_rank(world):
    torch.set_num_threads(1)
    group = sharding.default_process_group(world, "cpu")
    assert _driver("EI", group).suggest_chunk_size == 1
    assert tbo.BayesianOptimizer(objective_func=Branin(), device="cpu",
                                 n_devices=world).suggest_chunk_size == \
        200 // world
    return {m: _iteration(m, group) for m in ("KG", "EI")}


def _assert_iteration_equal(got, ref):
    np.testing.assert_allclose(got["hypers"], ref["hypers"], rtol=1e-11,
                               atol=1e-11)
    np.testing.assert_allclose(got["suggested"], ref["suggested"],
                               rtol=1e-11, atol=1e-11)
    assert abs(got["voi"] - ref["voi"]) <= \
        1e-9 * max(abs(ref["voi"]), 1e-12) + 1e-11
    np.testing.assert_allclose(got["recommended"], ref["recommended"],
                               rtol=1e-9, atol=1e-11)
    assert got["chain_steps"] == ref["chain_steps"]


@WORLDS
def test_driver_iteration_on_a_group_equals_unsharded(tmp_path, world):
    """One ``BayesianOptimizer`` iteration for method "KG" and for "EI"
    on 2 and 4 ranks (sharded chain, seeding q-EI, KG or EI multistart and
    recommend grid; chunk 1, so the gates span the same starts): hypers
    and points at rtol 1e-11, VOI 1e-9, recommendation 1e-9, on every
    rank.  ``n_devices`` takes the initialized group and a chunk of
    200 / world by default."""
    single = {m: _iteration(m, None) for m in ("KG", "EI")}
    for got in _run_group(tmp_path, world, _iteration_rank, world):
        for m in ("KG", "EI"):
            _assert_iteration_equal(got[m], single[m])


def _resume_rank(path):
    """Two iterations in one run, against one iteration with a checkpoint
    (rank 0 writes), a fresh driver on every rank that resumes from it,
    and the second iteration."""
    torch.set_num_threads(1)
    group = torch.distributed.group.WORLD

    def driver(**kw):
        return _driver("EI", group, standardize=True, noisy=True, **kw)

    whole = driver().run(2, num_init_pts=6)[1]
    driver(checkpoint_path=path).run(1, num_init_pts=6)
    resumed = driver(checkpoint_path=path)
    meta = resumed.resume()
    again = resumed.run(2, start_iteration=1)[-1]
    return {"meta": meta, "whole": whole, "again": again,
            "group_attached": resumed.model.process_group is group,
            "num_sampled": resumed.model._data.num_sampled}


def test_resume_on_a_group_equals_an_uninterrupted_run(tmp_path):
    """On 2 ranks, rank 0 writes the checkpoint and every rank resumes from
    it with the group re-attached: the resumed second iteration equals the
    uninterrupted one bit for bit, on both ranks, and both ranks agree."""
    path = str(tmp_path / "run.ckpt")
    ranks = _run_group(tmp_path, 2, _resume_rank, path)
    for r in ranks:
        assert r["meta"] == {"iteration": 0, "method": "EI", "capital": 0.0}
        assert r["group_attached"] and r["num_sampled"] == 10
        for k in ("suggested", "recommended"):
            np.testing.assert_array_equal(r["again"][k], r["whole"][k])
            np.testing.assert_array_equal(r["again"][k],
                                          ranks[0]["again"][k])
        assert r["again"]["voi"] == r["whole"]["voi"] == \
            ranks[0]["again"]["voi"]
        assert r["again"]["true_value"] == r["whole"]["true_value"]


def test_a_failed_rank_fails_the_group(tmp_path):
    """A rank that raises fails ``run_process_group`` with its traceback,
    and the other rank, left waiting in a collective, is stopped."""
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed"):
        _run_group(tmp_path, 2, _failing_rank)


def _failing_rank():
    if torch.distributed.get_rank() == 1:
        raise ValueError("rank 1 gives up")
    torch.distributed.barrier()


def test_more_devices_than_ranks_refused(tmp_path):
    with pytest.raises(RuntimeError, match="ValueError"):
        _run_group(tmp_path, 2, _wrong_world_rank)


def _wrong_world_rank():
    sharding.default_process_group(4, "cpu")
