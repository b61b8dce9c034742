#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on one NVIDIA GPU.

Run from the root of the repository on a machine with a CUDA card:

    python3 chip_smoke.py

It builds the CUDA kernels of ``cornell_moe_tpu_torch`` from ``csrc/``,
drives one q-KG iteration of ``BayesianOptimizer`` at the main path's size
(Branin, 500 observations, 16-member ensemble, q = 4, 200 multistarts,
128 MC draws, float32 on ``cuda:0``), checks that each kernel of that path
launched during the run (the stages run as CUDA graphs built once per shape
bucket, ``ops/programs.py``, whose replays count their launches), drives
the same path at 768 observations (``main_path_768``: the largest size at
which the JAX package runs all three of its kernels; its chain takes
kernel B's large-Np instance, and a second suggest in the same bucket
replays without a build), drives
two iterations with those programs and again with ``programs.CAPTURE =
"never"`` (the second iteration builds nothing, and both runs agree bit for
bit), drives the same iteration sharded over
``torch.distributed`` (``BayesianOptimizer(n_devices=)``): a world of one
over NCCL on ``cuda:0``, equal bit for bit to the unsharded iteration, its
chain and recommendation replayed as CUDA graphs with the NCCL gather
inside, and a world of two ranks over gloo, both on ``cuda:0`` (one card;
NCCL refuses two ranks on one GPU), each rank counting its own launches of
A, B and C, those two stages eager there by their rule, held to an
unsharded iteration with the same chunking, with the latency of the
chain's per-half-step ``all_gather``, eager and replayed; then it holds
each kernel
against its plain PyTorch version at the main path's shapes (the
covariance also against its own transpose, bit for bit; the fused LML
also against its large-Np instance,
the three timed side by side, with its cluster occupancy, and that
instance alone at W 8 and 16, Np 672, 768, 896 and 1008, above the
cluster's capacity, timed in turns with the plain version, and its
float64 instance, which a float64 model's chain takes, at W 8 and 16, Np
512, against and in turns with the plain version in float64; the KG
inner descent in both its instances, tensor-core and FMA, timed in
turns).
It drives one d-KG iteration (Branin with both partials observed, the
same size, 3 observation channels per point) and checks that it launched
none of the kernels, as the JAX package takes none on a derivative state;
on its data it runs a 64-step float64 d-KG chain (the benchmark's
dkg-branin-f64 cell) and checks that every log posterior went through the
tiled float64 Cholesky (``lml_chol_f64``, K's side 1536).  It holds that
kernel against its plain version at W 8 and 16, N 1536, and at N 1008,
timed in turns with the plain version and the library's factor and forward
solve, beside its fp64_mma bound.  Then it holds both instances of one
descent direction (``descent_grad``, tensor-core, and
``descent_grad_fma``) against the float64 plain version
and times them in turns, and drives the per-step route of the KG inner
descent (one ``descent_grad`` launch per GD step, the steps taken by
``gradient_ascent_batch``), which the main path does not take, at the main
path's shapes, checks that it went through its kernel, and holds it
against the float64 descent.  It runs the bfloat16 fantasy solve
(``config.KG_FANTASY_LOWP`` "always") on the main path's ensemble: its error
against float32 and float64, held to the JAX package's bounds on that package's
own test problems, and one suggest and retrain through the driver under it,
whose programs are keyed by the switch (back under "never", the next suggest
replays the "never" programs); then it flips each kernel switch between two
calls of one stage on the main path's driver (``switch_keys``: each switch
is part of every program's key, so "never" builds its own program and
launches nothing, and "auto" replays the first one bit for bit).  It
drives one continuous-fidelity KG iteration (``BraninFidelity``, the main
path's size, d = 3 with one fidelity dim: kernels B and C, no
kernel A) and holds B and C against their plain versions at that path's
shapes; one LCB batch selection on the main path's ensemble; and one
iteration of ``pes_driver.run_PES`` on Hartmann6 at the reference scale
(60 points, 100 hyperparameter sets, 1000 features, grid 500).  It
drives one ``BayesianOptimizer(method="EI")`` iteration at the main path's
size (kernels B and C, not A or D) with the ensemble q-EI multistart's
batched and per-start routes on its ensemble, heuristic q-EI on its
member 0 under
both estimation policies (C at the refit's ragged n 516, held against its
plain version there), the MAP fit on its model (no launch of B); the
cf-KG, EI, heuristic q-EI and MAP runs each take their stages through
programs and are held bit for bit to a second run with ``programs.CAPTURE
= "never"``; a
checkpoint and resume at a reduced depth (the resumed iteration equal bit
for bit to an uninterrupted one) and the command line
(``cornell_moe_tpu_torch.main``) on Branin, on Hartmann6 through HeSBO and
on KISSGP (d-KG on a real-function objective).  It runs the upstream
Cornell-MOE class flow through ``compat`` at the main path's width (the
chain, the ensemble, the KG multistart held bit for bit to the core's with
and without a point being sampled, the recommendation) and the single-GP
surface against its float64 CPU refit.
Last it checks the port against its own float64 CPU path on small inputs:
value-only, with derivative channels, with a fidelity dim, PES and EI, and
the covariance's dk/dx against autograd in float32.
Every phase
prints one JSON line; the kernels' summary is one JSON line, with each
kernel's device time (its own CUDA events under ``torch.profiler``) and
call time (CUDA events around the wrapper) beside its bound (the least
time the card could take for the same work); the last line is

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}

Without a CUDA device, or outside a checkout of the repository, it exits
non-zero and prints no result.  Any failed check raises.
"""

from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# TPU kernels replaced, by their pl.pallas_call line
PALLAS = "cornell_moe_tpu/ops/pallas_kernels.py"
SOURCES = {
    "descent_run": ("cornell_moe_tpu_torch/csrc/descent_run_mma.cu",
                    f"{PALLAS}:495"),
    "descent_run_fma": ("cornell_moe_tpu_torch/csrc/descent_run.cu",
                        f"{PALLAS}:495"),
    "descent_grad": ("cornell_moe_tpu_torch/csrc/descent_grad_mma.cu",
                     f"{PALLAS}:538"),
    "descent_grad_fma": ("cornell_moe_tpu_torch/csrc/descent_grad.cu",
                         f"{PALLAS}:538"),
    "lml_fused": ("cornell_moe_tpu_torch/csrc/lml_fused.cu", f"{PALLAS}:271"),
    "lml_fused_global": ("cornell_moe_tpu_torch/csrc/lml_fused.cu",
                         f"{PALLAS}:271"),
    "lml_fused_global_f64": ("cornell_moe_tpu_torch/csrc/lml_fused.cu",
                             f"{PALLAS}:271"),
    "covariance_with_noise": (
        "cornell_moe_tpu_torch/csrc/covariance_with_noise.cu",
        f"{PALLAS}:88"),
    "lml_chol_f64": ("cornell_moe_tpu_torch/csrc/lml_chol_f64.cu", None),
}
# the kernels the main path launches (descent_grad and descent_grad_fma
# serve the per-step route, driven by its own phase; every lml_fused launch
# takes the cluster instance, and the large-Np instance, lml_fused_global,
# none; every descent_run launch the tensor-core instance, and the FMA
# instance, descent_run_fma, none)
ON_MAIN_PATH = ("descent_run", "lml_fused", "covariance_with_noise")
NOT_ON_MAIN_PATH = ("lml_fused_global", "descent_run_fma", "descent_grad",
                    "descent_grad_fma")

# Main-path size, and the card it runs on
NUM_OBS, Q, N_HYPERS, NUM_MC, MULTISTARTS = 500, 4, 16, 128, 200
DEVICE = "cuda:0"

# The d-KG path (benchmarks/bench_suite.py:175-213): Branin with both
# partials observed at the main path's size
DKG_DERIVATIVES = (0, 1)

# The LCB selection: candidates and picks (main path's ensemble, member 0)
LCB_CANDIDATES = 10_000

# The PES path (benchmarks/bench_suite.py:246-336): Hartmann6, 60 initial
# points, M = 100 hyperparameter sets, burn-in 50, grid 500, one iteration
PES_INIT, PES_SETS, PES_BURNIN, PES_GRID = 60, 100, 50, 500

# The EI path: the main path's size with method "EI", whose MC draws
# default to 1024; heuristic q-EI on its member 0 refits at n0 + q points
EI_NUM_MC = 2**10
# The scale-out phase's group: SCALE_OUT_WORLD ranks over gloo, all on
# DEVICE, held within SCALE_OUT_RTOL of each quantity's scale to the
# unsharded iteration with the same chunking, within SCALE_OUT_TIMEOUT_S
SCALE_OUT_WORLD, SCALE_OUT_RTOL, SCALE_OUT_TIMEOUT_S = 2, 1e-4, 600.0
# the checkpoint phase's reduced depth: observations, members, burn-in,
# chain cap, q
CKPT_OBS, CKPT_HYPERS, CKPT_BURNIN, CKPT_CHAIN, CKPT_Q = 64, 8, 200, 128, 2
# the MAP fit's starts
MAP_RESTARTS = 4
# kernel B's large-Np instance is held to its plain version and timed
# where it serves alone, above the cluster instance's capacity (640): up to
# the gate's upper end (896, the JAX package's) and at 1008 (1000
# observations), where the gate sends the chain to the plain LML
LML_LARGE_NPS = (672, 768, 896, 1008)
# the main path at 768 observations: the largest size at which the JAX
# package runs all three of its kernels (B to 896, C to 768, A from 256);
# its chain takes B's large-Np instance (Np 768, then 784)
MAIN_768_OBS = 768


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def snapshot() -> dict:
    """The port's counters now, to read :func:`kernel_launches` from."""
    from cornell_moe_tpu_torch.utils import logging_utils
    return logging_utils.counters()


def kernel_launches(before) -> dict:
    """Each kernel's launches since ``before`` (a :func:`snapshot`): the
    growth of its counter ``kernels.<name>``; a kernel that did not launch
    is left out."""
    from cornell_moe_tpu_torch.utils import logging_utils
    return {name[len("kernels."):]: n for name, n in
            logging_utils.growth(before).items()
            if name.startswith("kernels.")}


def release(torch, bo) -> None:
    """Free a driver's programs (their CUDA graphs and pool) and what the
    allocator caches: the programs' closures hold the driver's model in a
    reference cycle, which only the garbage collector would break."""
    bo.program_cache.release()
    gc.collect()
    torch.cuda.empty_cache()


def provenance(torch) -> None:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    from cornell_moe_tpu_torch.ops import _build
    nvcc = subprocess.run([_build.find_nvcc(), "--version"],
                          capture_output=True, text=True, check=True)
    emit({"phase": "versions", "python": sys.version.split()[0],
          "torch": torch.__version__, "torch_cuda": torch.version.cuda,
          "nccl": ".".join(map(str, torch.cuda.nccl.version())),
          "nvcc": nvcc.stdout.strip().splitlines()[-1],
          "device": torch.cuda.get_device_name(0)})


def phase_build() -> None:
    from cornell_moe_tpu_torch.ops import _build
    t0 = time.time()
    _build.library()
    emit({"phase": "build", "seconds": time.time() - t0,
          "compile_seconds": _build.build_seconds,
          "library": os.path.relpath(str(_build.build()), HERE),
          "ptxas": _build.ptxas_report()})


def _iteration(torch, descent, **bo_kwargs):
    """One BO iteration through the driver at the main path's size
    (``tools.scale_out.iteration``: ``bo_kwargs`` added, kernel A's
    launches sent to ``descent``).  Returns the optimizer, the record, the
    wall time, the launches by kernel, A's launches and B's calls by
    shape."""
    from cornell_moe_tpu_torch.tools import scale_out
    check(scale_out.NUM_OBS == NUM_OBS and
          scale_out.MAIN_PATH["num_to_sample"] == Q and
          scale_out.MAIN_PATH["n_hypers"] == N_HYPERS,
          "main-path size changed")
    run = scale_out.iteration(DEVICE, descent, **bo_kwargs)
    check(run[0].sgd_params.num_multistarts == MULTISTARTS and
          run[0].num_mc == NUM_MC, "main-path size changed")
    return run


def _log_posterior_check(torch, label, m) -> None:
    """The model's log-posterior at its chain's walkers, through kernel B,
    against the float64 plain path: the kernel must be finite wherever
    float64 is, and its largest relative deviation must be within 5e-3 or
    no larger than the float32 plain path's own (at walkers whose K is too
    ill-conditioned for float32 either way)."""
    mx, my, mpn = m._padded_data()
    lp_k = m.log_posterior(m.p0, mx, my, mpn).double()
    lp_p = m.log_posterior(m.p0, mx, my, mpn, force_plain=True).double()
    lp_64 = m.log_posterior(m.p0.double(), mx.double(), my.double(),
                            mpn.double(), force_plain=True)
    scale = lp_64.abs().clamp_min(1.0)
    inf = torch.full_like(lp_64, float("inf"))
    dev_k = torch.where(torch.isfinite(lp_k),
                        (lp_k - lp_64).abs() / scale, inf)
    dev_p = torch.where(torch.isfinite(lp_p),
                        (lp_p - lp_64).abs() / scale, inf)
    fin = torch.isfinite(lp_64)
    ok = bool(fin.any()) and bool(torch.isfinite(dev_k[fin]).all()) \
        and dev_k[fin].max().item() <= max(5e-3, dev_p[fin].max().item())
    both = torch.isfinite(lp_k) & torch.isfinite(lp_p)
    emit({"phase": "equivalence", "check": "log_posterior",
          "walkers_from": label, "walkers": int(m.p0.shape[0]),
          "padded_n": int(mx.shape[0]),
          "finite": {"kernel": int(torch.isfinite(lp_k).sum()),
                     "plain_f32": int(torch.isfinite(lp_p).sum()),
                     "plain_f64": int(fin.sum())},
          "max_rel_dev_kernel_vs_f64": _finite_or_none(dev_k[fin]),
          "max_rel_dev_plain_f32_vs_f64": _finite_or_none(dev_p[fin]),
          "max_rel_dev_kernel_vs_plain_f32":
              ((lp_k - lp_p).abs() / lp_p.abs().clamp_min(1.0))[
                  both].max().item() if bool(both.any()) else None,
          "walker_median_theta": m.p0.median(dim=0).values.tolist(),
          "tolerance": "vs f64: max rel 5e-3 or the plain f32 "
                       "path's own max deviation", "ok": ok})
    check(ok, f"kernel log-posterior check failed ({label})")


def _kg_voi_members(torch, states, union, discrete_pts, normals, domain,
                    inner_params, best_so_far, derivatives_to_sample=(),
                    num_fidelity=0, program_cache=None) -> dict:
    """Per ensemble member, at a suggest's VOI scoring (the arguments of
    ``score_knowledge_gradient_mcmc``), recomputed eagerly: the member's
    KG (its mean is the VOI), and for the members whose KG is not finite
    their fantasy noise, whether their per-union fantasy factor (the VOI's,
    ``_build_fantasy_model``) and their batched one (the multistart's,
    ``_build_fantasy_model_batch``) are finite, and the union's float32
    posterior variance's least eigenvalue and diagonal."""
    from cornell_moe_tpu_torch.acquisition import knowledge_gradient as kg
    from cornell_moe_tpu_torch.models import gp as gp_mod
    del program_cache
    vals = kg.knowledge_gradient(
        states, union, discrete_pts, normals, domain, inner_params,
        torch.as_tensor(best_so_far), derivatives_to_sample, num_fidelity)
    bad = [i for i in range(vals.shape[0])
           if not math.isfinite(vals[i].item())]
    out = {"kg": vals.tolist(), "nonfinite": bad}
    if bad:
        _, chol_u, _ = kg._build_fantasy_model(states, union)
        _, chol_b, _, noise_eff = kg._build_fantasy_model_batch(
            states, union[None])
        var = gp_mod.posterior_variance(states, union)
        out["members"] = {str(i): {
            "noise_variance": states.noise_variance[i].tolist(),
            "fantasy_factor_finite": bool(torch.isfinite(chol_u[i]).all()),
            "batched_factor_finite": bool(torch.isfinite(chol_b[i]).all()),
            "batched_noise_eff": noise_eff[i, 0].tolist(),
            "least_eigenvalue": torch.linalg.eigvalsh(
                var[i].double())[0].item()
            if bool(torch.isfinite(var[i]).all()) else None,
            "diagonal": torch.diagonal(var[i]).tolist()} for i in bad}
    return out


def phase_main_768(torch) -> dict:
    """The main path at MAIN_768_OBS observations through
    ``BayesianOptimizer``'s entry points (initialize, suggest, a second
    suggest in the same bucket, observe and recommend) at the main path's
    settings (Branin on its raw
    domain, 16 members, q = 4, 200 multistarts, 128 MC draws, float32,
    standardized, noisy), its launches read from just before: each stage's time
    and builds, the chains' steps, the VOIs, suggested and recommended points,
    launches by kernel and by shape, and builds and replays by program
    kind.  The chain's Np (768, then 784 after the 4 new points) lies above the
    cluster instance's capacity and within the gate: every B launch takes the
    large-Np instance, none the cluster one; A and C launch; the replayed
    suggest builds nothing.  The chain's final walkers' log posteriors pass the
    main path's rule (:func:`_log_posterior_check`).  Each suggest's VOI,
    the ensemble mean of the members' KG at its union, is finite, or NaN
    only through members whose float32 fantasy factor at that union fails
    (``voi_members``, :func:`_kg_voi_members`): as in the JAX package,
    whose per-union fantasy model shifts the diagonal by the same repair
    and no more.  Returns the counts."""
    from cornell_moe_tpu_torch.acquisition import knowledge_gradient as kg
    from cornell_moe_tpu_torch.bayes_opt import BayesianOptimizer
    from cornell_moe_tpu_torch.ops import kernels, programs
    from cornell_moe_tpu_torch.tools import scale_out
    from cornell_moe_tpu_torch.utils.synthetic_functions import Branin

    bo = BayesianOptimizer(**dict(scale_out.MAIN_PATH,
                                  objective_func=Branin(), device=DEVICE))
    check(bo.sgd_params.num_multistarts == MULTISTARTS and
          bo.num_mc == NUM_MC, "main-path size changed")
    stages, replays = {}, {}
    scored, score = [], kg.score_knowledge_gradient_mcmc

    def recording_score(*args, **kw):
        scored.append((args, kw))
        return score(*args, **kw)

    def timed(name, fn, *args):
        b0 = programs.build_count()
        t0 = time.time()
        out = fn(*args)
        torch.cuda.synchronize()
        stages[name] = {"seconds": time.time() - t0,
                        "builds": programs.build_count() - b0}
        replays[name] = {k: v["replays"] for k, v in
                         programs.by_kind(bo.program_cache).items()}
        return out

    torch.cuda.synchronize()
    before = snapshot()
    kg.score_knowledge_gradient_mcmc = recording_score
    try:
        with scale_out.recording() as (shapes, lml_shapes):
            t0 = time.time()
            timed("initialize", bo.initialize, MAIN_768_OBS)
            np_first = int(bo.model.models.chol_K.shape[-1])
            pts, voi = timed("suggest", bo.suggest)
            pts2, voi2 = timed("suggest_replayed", bo.suggest)
            timed("observe_retrain", bo.observe, pts)
            rec = timed("recommend", bo.recommend)
            torch.cuda.synchronize()
            wall = time.time() - t0
    finally:
        kg.score_knowledge_gradient_mcmc = score
    counts = kernel_launches(before)
    voi_members = [_kg_voi_members(torch, *a, **k) for a, k in scored]
    true_value = float(bo.objective_func.evaluate_true(rec)[0])
    states = bo.model.models
    replayed = {k: v - replays["suggest"].get(k, 0)
                for k, v in replays["suggest_replayed"].items()
                if v != replays["suggest"].get(k, 0)}
    emit({"phase": "main_path_768", "seconds": wall, "stages": stages,
          "num_sampled": int(bo.model._data.num_sampled),
          "ensemble": int(states.chol_K.shape[0]),
          "padded_n": [np_first, int(states.chol_K.shape[-1])],
          "chain_steps": bo.model.chain_steps,
          "members_replaced": bo.model.members_replaced,
          "voi": voi, "suggested": pts.tolist(),
          "voi_replayed_suggest": voi2,
          "suggested_replayed": pts2.tolist(),
          "recommended": rec.tolist(), "true_value": true_value,
          "launches": counts, "descent_run_launches_by_shape": shapes,
          "lml_fused_calls_by_shape": lml_shapes,
          "lml_instance_by_shape": {
              k: kernels.lml_fused_instance(int(k.split("_Np")[1]))
              for k in lml_shapes},
          "programs": programs.by_kind(bo.program_cache),
          "replays_in_replayed_suggest": replayed,
          "voi_members": voi_members})
    for v, members in zip((voi, voi2), voi_members):
        check(math.isfinite(v) if not members["nonfinite"] else
              math.isnan(v) and not any(
                  m["fantasy_factor_finite"]
                  for m in members["members"].values()),
              f"main_path_768 VOI {v} neither finite nor NaN from members "
              f"whose float32 fantasy factor fails: {members}")
    bounds = bo.objective_func._search_domain
    check(_domain_check(rec, bounds),
          f"main_path_768 recommended point {rec} outside the domain")
    check(bool(torch.isfinite(states.chol_K).all()),
          "a main_path_768 ensemble member's chol_K is non-finite")
    for name in ("descent_run", "covariance_with_noise", "lml_fused_global"):
        check(counts.get(name, 0) > 0, f"main_path_768 did not launch {name}")
    check(counts.get("lml_fused", 0) == 0,
          "main_path_768 launched B's cluster instance")
    check(stages["suggest_replayed"]["builds"] == 0 and replayed,
          f"the replayed suggest built programs: {stages}")
    _log_posterior_check(torch, "main_path_768_walkers", bo.model)
    release(torch, bo)
    return counts


def phase_main(torch):
    """One BO iteration through the driver; returns the optimizer and its
    launch counts.  Then the same iteration again with kernel A's launches
    sent to its FMA instance (``descent_run_fma``), as a witness: the first
    chain runs before any A launch and must take the same steps in both;
    the second chain and the VOI follow the suggested points, which move
    with A's rounding."""
    from cornell_moe_tpu_torch.ops import kernels

    bo, rec, wall, counts, descent_shapes, lml_shapes = _iteration(
        torch, kernels.descent_run)
    states = bo.model.models
    emit({"phase": "main_path", "seconds": wall,
          "stages": {r["phase"]: r["seconds"] for r in bo.timer.records},
          "num_sampled": int(bo.model._data.num_sampled),
          "ensemble": int(states.chol_K.shape[0]),
          "padded_n": int(states.chol_K.shape[-1]),
          "burnin_steps": bo.burnin_steps,
          "chain_steps": bo.model.chain_steps,
          "voi": rec["voi"], "suggested": rec["suggested"].tolist(),
          "recommended": rec["recommended"].tolist(),
          "true_value": rec["true_value"], "launches": counts,
          "descent_run_launches_by_shape": descent_shapes,
          "lml_fused_calls_by_shape": lml_shapes})
    check(math.isfinite(rec["voi"]), f"VOI not finite: {rec['voi']}")
    bounds = bo.objective_func._search_domain
    r = rec["recommended"]
    check(bool(((r >= bounds[:, 0]) & (r <= bounds[:, 1])).all()),
          f"recommended point {r} outside the domain")
    check(bool(torch.isfinite(states.chol_K).all()),
          "an ensemble member's chol_K is non-finite")
    for name in ON_MAIN_PATH:
        check(counts.get(name, 0) > 0,
              f"kernel {name} was not launched on the main path")
    for name in NOT_ON_MAIN_PATH:
        check(counts.get(name, 0) == 0, f"the main path launched {name}")
    check(sum(descent_shapes.values()) == counts.get("descent_run", 0),
          "descent_run launches and recorded shapes disagree")

    wbo, wrec, wwall, wcounts, wshapes, _ = _iteration(
        torch, kernels.descent_run_fma)
    emit({"phase": "main_path_fma_witness", "seconds": wwall,
          "chain_steps": wbo.model.chain_steps, "voi": wrec["voi"],
          "suggested": wrec["suggested"].tolist(), "launches": wcounts,
          "descent_run_launches_by_shape": wshapes,
          "first_chain_as_main_path":
              wbo.model.chain_steps[0] == bo.model.chain_steps[0]})
    check(math.isfinite(wrec["voi"]),
          f"witness VOI not finite: {wrec['voi']}")
    check(wcounts.get("descent_run", 0) == 0 and
          wcounts.get("descent_run_fma", 0) == sum(wshapes.values()) > 0,
          "the witness run did not send every A launch to the FMA instance")
    check(wbo.model.chain_steps[0] == bo.model.chain_steps[0],
          "the chain before any A launch moved in the witness")
    release(torch, wbo)
    del wbo
    return bo, rec, counts


PROGRAM_ITERATIONS = 2
# the programs the EI path replays (the cf-KG path: the main path's)
EI_PROGRAM_KINDS = ("chain_64", "fit", "ei_step", "ei_score",
                    "recommend_grid", "recommend_step")
# the main path's programs, each replayed in every iteration (and cf-KG's)
PROGRAM_KINDS = ("chain_64", "fit", "qei_step", "posterior_mean_step",
                 "kg_cold", "kg_warm_step", "kg_score", "recommend_grid",
                 "recommend_step")


def _program_run(torch, capture: str) -> dict:
    """PROGRAM_ITERATIONS main-path iterations through the driver's entry
    points (initialize, then suggest, observe and recommend) with
    ``programs.CAPTURE`` = ``capture``: each stage's wall time and builds,
    each program's replays after each iteration, launches, the memory
    allocated before and at the peak, and the results."""
    import numpy as np
    from cornell_moe_tpu_torch.bayes_opt import BayesianOptimizer
    from cornell_moe_tpu_torch.ops import programs
    from cornell_moe_tpu_torch.tools import scale_out
    from cornell_moe_tpu_torch.utils.synthetic_functions import Branin

    programs.CAPTURE = capture
    try:
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        allocated = torch.cuda.memory_allocated()
        bo = BayesianOptimizer(**dict(scale_out.MAIN_PATH,
                                      objective_func=Branin(),
                                      device=DEVICE))
        before = snapshot()
        stages, replays, results = [], [], []

        def timed(name, fn, *args):
            b0 = programs.build_count()
            t0 = time.time()
            out = fn(*args)
            torch.cuda.synchronize()
            stages[-1][name] = {"seconds": time.time() - t0,
                                "builds": programs.build_count() - b0}
            return out

        stages.append({})
        timed("initialize", bo.initialize, NUM_OBS)
        for _ in range(PROGRAM_ITERATIONS):
            stages.append({})
            pts, voi = timed("suggest", bo.suggest)
            timed("observe_retrain", bo.observe, pts)
            rec = timed("recommend", bo.recommend)
            replays.append({k: v["replays"] for k, v in
                            programs.by_kind(
                                bo.program_cache).items()})
            results.append({"suggested": pts, "voi": voi,
                            "recommended": rec,
                            "walkers": bo.model.p0.cpu().numpy(),
                            "hypers": np.asarray(bo.model.hypers)})
        torch.cuda.synchronize()
        return {"optimizer": bo, "stages": stages, "replays": replays,
                "capture_seconds": {
                    programs.kind(key): prog.capture_seconds
                    for key, prog in bo.program_cache.programs().items()},
                "launches": kernel_launches(before),
                "chain_steps": bo.model.chain_steps,
                "members_replaced": bo.model.members_replaced,
                "memory_allocated_before": allocated,
                "max_memory_allocated": torch.cuda.max_memory_allocated(),
                "results": results}
    finally:
        programs.CAPTURE = "auto"


def phase_programs(torch) -> None:
    """The main path's programs per shape bucket: PROGRAM_ITERATIONS
    iterations at full width (500 -> 504 -> 508 observations, all in
    bucket 512) with programs (CUDA graphs: the chain's 64-step segment
    and its 16-step burn-in remainder, the ensemble fit, the seeding
    q-EI's GD step and posterior-mean polish step, the KG multistart's
    cold evaluation with kernel A's 6-step launch and its warm outer step
    with A's one-step launch, the VOI's scoring, the recommendation's grid
    and its polish step) and again with
    ``programs.CAPTURE = "never"``.  The first iteration builds, the
    second builds nothing and replays; the two runs agree bit for bit
    (suggested points, VOI, recommendation, walkers, hypers, chain steps)
    and launch the same kernels as often.  A third recommendation from
    the programs' optimizer times the replayed polish alone."""
    import numpy as np

    from cornell_moe_tpu_torch.bayes_opt import DEFAULT_SGD_PARAMS_RECOMMEND

    on = _program_run(torch, "auto")
    bo = on.pop("optimizer")
    torch.cuda.synchronize()
    t0 = time.time()
    bo.recommend()
    torch.cuda.synchronize()
    on["recommend_wall_ms_per_polish_step"] = (time.time() - t0) * 1e3 / \
        DEFAULT_SGD_PARAMS_RECOMMEND.max_num_steps
    release(torch, bo)
    del bo
    off = _program_run(torch, "never")
    release(torch, off.pop("optimizer"))
    bitwise = [{k: bool(np.array_equal(np.asarray(a[k]), np.asarray(b[k])))
                for k in a} for a, b in zip(on["results"], off["results"])]
    printable = {k: v for k, v in on.items() if k != "results"}
    emit({"phase": "programs", "iterations": PROGRAM_ITERATIONS,
          "programs": printable,
          "never": {k: off[k] for k in ("stages", "launches", "chain_steps",
                                        "memory_allocated_before",
                                        "max_memory_allocated")},
          "vois": [r["voi"] for r in on["results"]],
          "bitwise_equal_to_never": bitwise,
          "chain_steps_equal": on["chain_steps"] == off["chain_steps"],
          "launches_equal": on["launches"] == off["launches"]})
    builds = [sum(v["builds"] for v in it.values()) for it in on["stages"]]
    check(builds[0] > 0 and builds[1] > 0,
          f"the first main-path iteration built no program: {builds}")
    check(all(b == 0 for b in builds[2:]),
          f"an iteration inside bucket 512 built programs: {builds}")
    check(sum(sum(v["builds"] for v in it.values())
              for it in off["stages"]) == 0,
          "CAPTURE = 'never' built programs")
    last, first = on["replays"][-1], on["replays"][0]
    for kind in PROGRAM_KINDS:
        check(last.get(kind, 0) > first.get(kind, 0),
              f"the {kind} program did not replay in the second iteration")
    check(all(all(b.values()) for b in bitwise) and
          on["chain_steps"] == off["chain_steps"],
          f"programs and CAPTURE = 'never' disagree: {bitwise}")
    check(on["launches"] == off["launches"],
          f"launches with programs {on['launches']} and without "
          f"{off['launches']} differ")


def _scale_out_rank() -> dict:
    """One rank of the scale-out phase's gloo group: the main path's
    iteration on cuda:0 with ``n_devices`` = SCALE_OUT_WORLD (the restart
    axis, the walkers and the recommend grid sharded over the ranks), its
    launches read from just before."""
    import torch
    from cornell_moe_tpu_torch.ops import kernels
    from cornell_moe_tpu_torch.tools import scale_out
    from cornell_moe_tpu_torch.bayes_opt import recommend_runs_program
    from cornell_moe_tpu_torch.models.mcmc import chain_runs_programs
    group = torch.distributed.group.WORLD
    run = _iteration(torch, kernels.descent_run, n_devices=SCALE_OUT_WORLD)
    out = scale_out.summary(*run)
    release(torch, run[0])
    del run
    out["rank"] = torch.distributed.get_rank()
    out["backend"] = str(torch.distributed.get_backend())
    out["chain_runs_programs"] = chain_runs_programs(group, DEVICE)
    out["recommend_runs_program"] = recommend_runs_program(group, DEVICE)
    out["all_gather_ms"] = scale_out.gather_ms(group, DEVICE, N_HYPERS // 2)
    return out


def phase_scale_out(torch, main_bo, main_rec) -> None:
    """The main path's iteration sharded (``BayesianOptimizer(n_devices=)``,
    ``parallel.sharding``), twice.  (a) A world of one over NCCL on cuda:0,
    the group made by ``n_devices=1`` itself: equal bit for bit to the
    main path's unsharded iteration (its chunk, 200 / 1, is one chunk),
    its chain's segments and its recommendation's grid run as replayed
    CUDA graphs with their NCCL gathers inside; the gather's host time is
    read eagerly and replayed inside a graph, and the graphs are freed
    before the group is destroyed.
    (b) A world of SCALE_OUT_WORLD ranks over gloo, spawned here, every
    rank on cuda:0 (the machine has one card, and NCCL refuses two ranks on
    one GPU): each rank counts its own launches of A, B and C, the ranks
    must agree bit for bit, and each is held to an unsharded iteration
    with the same chunking (suggest_chunk_size 200 / SCALE_OUT_WORLD)
    within SCALE_OUT_RTOL of each quantity's scale; the chain and the
    recommendation stay eager there by their rule (a gloo gather runs on
    the host)."""
    import tempfile

    import numpy as np
    import torch.distributed as dist
    from cornell_moe_tpu_torch.ops import kernels
    from cornell_moe_tpu_torch.parallel import spawn
    from cornell_moe_tpu_torch.tools import scale_out

    main = {"walkers": main_bo.model.p0.cpu().numpy(),
            "hypers": np.asarray(main_bo.model.hypers),
            "chain_steps": list(main_bo.model.chain_steps),
            **{k: main_rec[k] for k in ("suggested", "voi", "recommended",
                                        "true_value")}}
    t0 = time.time()
    run = _iteration(torch, kernels.descent_run, n_devices=1)
    group = run[0].process_group
    one = {"backend": str(dist.get_backend(group)),
           "world": dist.get_world_size(group),
           "all_gather_ms": scale_out.gather_ms(group, DEVICE,
                                                N_HYPERS // 2),
           "all_gather_replayed_ms": scale_out.replayed_gather_ms(
               group, DEVICE, N_HYPERS // 2)}
    one.update(scale_out.summary(*run))
    release(torch, run[0])
    del run
    dist.destroy_process_group()
    one["bitwise_equal_to_main_path"] = scale_out.bitwise(one, main)

    chunk = MULTISTARTS // SCALE_OUT_WORLD
    np_ = main_bo.model.models.chol_K.shape[-1]
    ref = scale_out.summary(*_iteration(torch, kernels.descent_run,
                                        suggest_chunk_size=chunk))
    t1 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        ranks = spawn.run_process_group(
            _scale_out_rank, SCALE_OUT_WORLD, os.path.join(tmp, "store"),
            timeout_s=SCALE_OUT_TIMEOUT_S)
    group_wall = time.time() - t1
    width = np.ptp(main_bo.objective_func._search_domain, axis=1)
    errors = scale_out.errors_over_scale(ranks[0], ref, width)
    ranks_agree = scale_out.bitwise(ranks[0], ranks[1])
    emit({"phase": "scale_out", "seconds": time.time() - t0,
          "nccl_world_of_one": scale_out.printable(one),
          "gloo_world": {
              "world": SCALE_OUT_WORLD, "device": DEVICE,
              "group_seconds": group_wall,
              "ranks": [scale_out.printable(r) for r in ranks],
              "ranks_bitwise_equal": ranks_agree,
              "unsharded_chunk_100": scale_out.printable(ref),
              "bitwise_equal_to_unsharded": scale_out.bitwise(ranks[0],
                                                              ref),
              "max_err_over_scale": errors,
              "tolerance": f"<= {SCALE_OUT_RTOL} of scale (walkers: "
                           "max(1, |walker|); points: domain width; VOI: "
                           "|VOI|)"}})
    check(one["backend"] == "nccl" and one["world"] == 1 and
          one["suggest_chunk_size"] == MULTISTARTS,
          f"the world of one is not NCCL with one chunk: {one}")
    check(all(one["bitwise_equal_to_main_path"].values()),
          "the NCCL world of one differs from the main path: "
          f"{one['bitwise_equal_to_main_path']}")
    for kind in ("chain_64", "recommend_grid"):
        check(one["programs"].get(kind, {}).get("replays", 0) > 0,
              f"the NCCL world of one did not replay {kind}: "
              f"{one['programs']}")
    check(one["all_gather_replayed_ms"] is not None,
          "the NCCL gather was not replayed inside a graph")
    for r in [one] + ranks:
        for name in ON_MAIN_PATH:
            check(r["launches"].get(name, 0) > 0,
                  f"{name} not launched in a scale-out run: {r['launches']}")
    for r in ranks:
        check(r["backend"] == "gloo" and
              r["suggest_chunk_size"] == chunk and
              all(key.split("_")[1] == f"B{chunk}"
                  for key in r["descent_run_launches_by_shape"]) and
              {f"W{N_HYPERS // 2 // SCALE_OUT_WORLD}_Np{np_}",
               f"W{N_HYPERS // SCALE_OUT_WORLD}_Np{np_}"} ==
              set(r["lml_fused_calls_by_shape"]),
              f"rank {r['rank']} did not run its shard's shapes")
    for r in ranks:
        check(not r["chain_runs_programs"] and
              not r["recommend_runs_program"] and
              not any(k.startswith("chain") or k == "recommend_grid"
                      for k in r["programs"]),
              f"rank {r['rank']} captured a gloo stage: {r['programs']}")
    check(all(ranks_agree.values()), f"the ranks disagree: {ranks_agree}")
    check(all(e <= SCALE_OUT_RTOL for e in errors.values()),
          f"the gloo world differs from the unsharded run: {errors}")


def phase_dkg(torch) -> None:
    """One d-KG iteration through the driver at the main path's size:
    Branin with both partials observed (500 points x 3 channels, K's side
    1536 after the 16-point bucket), 16 members, q = 4, 200 multistarts,
    128 MC draws, float32.  Its launches are read from just before: the
    three kernels' gates send derivative states to the plain path, so none
    may launch."""
    from cornell_moe_tpu_torch.bayes_opt import BayesianOptimizer
    from cornell_moe_tpu_torch.utils.synthetic_functions import \
        BraninWithDerivatives

    bo = BayesianOptimizer(objective_func=BraninWithDerivatives(),
                           method="KG", num_to_sample=Q, n_hypers=N_HYPERS,
                           noisy=True, standardize=True, device=DEVICE,
                           dtype=torch.float32, verbose=False)
    check(bo.derivatives == DKG_DERIVATIVES and
          bo.sgd_params.num_multistarts == MULTISTARTS and
          bo.num_mc == NUM_MC, "d-KG size changed")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = snapshot()
    t0 = time.time()
    rec = bo.run(num_iterations=1, num_init_pts=NUM_OBS)[-1]
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = kernel_launches(before)
    states = bo.model.models
    emit({"phase": "dkg_path", "seconds": wall,
          "stages": {r["phase"]: r["seconds"] for r in bo.timer.records},
          "num_sampled": int(bo.model._data.num_sampled),
          "derivatives": list(bo.derivatives),
          "ensemble": int(states.chol_K.shape[0]),
          "padded_n": int(states.points_sampled.shape[-2]),
          "channels": 1 + len(bo.derivatives),
          "k_side": int(states.chol_K.shape[-1]),
          "noise_variance_shape": list(states.noise_variance.shape),
          "burnin_steps": bo.burnin_steps, "chain_cap": bo.chain_length,
          "chain_steps": bo.model.chain_steps,
          "members_replaced": bo.model.members_replaced,
          "suggest_chunk_size": bo.suggest_chunk_size,
          "voi": rec["voi"], "suggested": rec["suggested"].tolist(),
          "recommended": rec["recommended"].tolist(),
          "true_value": rec["true_value"],
          "max_memory_allocated": torch.cuda.max_memory_allocated(),
          "launches": counts})
    check(states.chol_K.shape[-1] == 3 * 512 and
          tuple(states.noise_variance.shape) == (N_HYPERS, 3),
          "the d-KG ensemble is not 16 members over 3 x 512 channels")
    check(math.isfinite(rec["voi"]), f"d-KG VOI not finite: {rec['voi']}")
    check(bool(torch.isfinite(states.chol_K).all()),
          "a d-KG ensemble member's chol_K is non-finite")
    r = rec["recommended"]
    bounds = bo.objective_func._search_domain
    check(bool(((r >= bounds[:, 0]) & (r <= bounds[:, 1])).all()) and
          math.isfinite(rec["true_value"]),
          f"d-KG recommendation {r} outside the domain or not finite")
    for name in ON_MAIN_PATH + ("lml_chol_f64",):
        check(counts.get(name, 0) == 0,
              f"the float32 d-KG path launched {name}")
    del states
    _dkg_chain_f64(torch, bo.model)
    release(torch, bo)
    del bo


DKG_F64_STEPS = 64        # one captured segment of the float64 d-KG chain


def _dkg_chain_f64(torch, model32) -> None:
    """The float64 d-KG chain (the benchmark's dkg-branin-f64 cell) on the
    float32 path's data: DKG_F64_STEPS stretch moves through the chain's
    segment program, each log posterior one launch of the tiled Cholesky
    (kernels.lml_chol_f64) at K's side 1536, 16 walkers at the start and 8
    a half-step, and model.lml_plain growing by the walkers it takes."""
    from cornell_moe_tpu_torch.models import mcmc
    from cornell_moe_tpu_torch.utils import logging_utils

    m = mcmc.GaussianProcessLogLikelihoodMCMC(
        model32._data, derivatives=model32.derivatives, noisy=True,
        bucket=model32.bucket, standardize=True, n_hypers=N_HYPERS,
        device=DEVICE, dtype=torch.float64,
        generator=torch.Generator(device=DEVICE).manual_seed(25))
    x, y, pn = m._padded_data()
    check(x.shape[0] * (1 + len(m.derivatives)) == 1536,
          f"the float64 d-KG system's side is {x.shape[0]} x 3, not 1536")
    check(mcmc.lml_route("cuda", torch.float64, m.derivatives, x.shape[0])
          == "chol", "the float64 d-KG chain does not route to lml_chol_f64")
    p0 = torch.clamp(m.prior.sample_from_prior(
        m.generator, N_HYPERS, device=DEVICE, dtype=torch.float64),
        -mcmc.LOG_BOUND + 1e-3, mcmc.LOG_BOUND - 1e-3)
    before = logging_utils.counters()
    torch.cuda.synchronize()
    t0 = time.time()
    m.p0, lp = mcmc.run_ensemble_mcmc(
        m.generator, lambda t: m.log_posterior(t, x, y, pn), p0,
        DKG_F64_STEPS, segment_fn=m._segment_program(x, y, pn))
    torch.cuda.synchronize()
    growth = logging_utils.growth(before)
    grew = {name: growth.get(name, 0)
            for name in ("kernels.lml_chol_f64", "model.lml_plain",
                         "kernels.lml_fused_global_f64")}
    emit({"phase": "dkg_chain_f64", "steps": DKG_F64_STEPS,
          "seconds": time.time() - t0, "walkers": N_HYPERS, "k_side": 1536,
          "counters": grew, "finite_walkers": int(torch.isfinite(lp).sum())})
    check(grew["kernels.lml_chol_f64"] == 1 + 2 * DKG_F64_STEPS and
          grew["model.lml_plain"] == N_HYPERS * (1 + DKG_F64_STEPS) and
          grew["kernels.lml_fused_global_f64"] == 0,
          f"the float64 d-KG chain did not go through lml_chol_f64: {grew}")
    check(int(torch.isfinite(lp).sum()) == N_HYPERS,
          "a float64 d-KG walker's log posterior is not finite")
    m.program_cache.release()


def _chol_system(torch, w, np_, derivatives, seed):
    """K (W, N, N) and y (N,) of the float64 log posterior: np_ Branin
    points with the values of BraninWithDerivatives' channels, Matern 5/2
    over 1 + len(derivatives) channels, walkers' noise 1e-3 to 1e-2 of the
    amplitude."""
    import numpy as np

    from cornell_moe_tpu_torch.models import covariance as cov_mod
    from cornell_moe_tpu_torch.models import likelihood as lik_mod
    from cornell_moe_tpu_torch.utils.synthetic_functions import \
        BraninWithDerivatives

    fn = BraninWithDerivatives()
    dom = fn._search_domain
    rng = np.random.default_rng(seed)
    pts = rng.uniform(dom[:, 0], dom[:, 1], (np_, 2))
    vals = np.stack([fn.evaluate_true(p) for p in pts])[:, :1 + len(
        derivatives)]
    vals = vals / vals[:, 0].std()
    f64 = dict(dtype=torch.float64, device=DEVICE)
    width = dom[:, 1] - dom[:, 0]
    hyps = np.concatenate([rng.uniform(0.5, 1.5, (w, 1)),
                           width * rng.uniform(0.2, 0.4, (w, 2))], axis=1)
    noise = rng.uniform(1e-3, 1e-2, (w, 1 + len(derivatives)))
    cov = cov_mod.COVARIANCE_TYPES["matern_2.5"](
        hyperparameters=torch.tensor(hyps, **f64))
    return lik_mod.training_system(
        cov, torch.tensor(noise, **f64), torch.tensor(pts, **f64),
        torch.tensor(vals, **f64), derivatives)


def _chol_kernel_ms(torch, k0, y, reps: int) -> dict:
    """The tiled Cholesky's time on a fresh copy of K each call (it factors
    in place): device_ms, its kernel's CUDA events alone under
    torch.profiler, the median over the calls whose event the profiler
    recorded (at least half of them, else a miscount fails the script);
    call_ms, CUDA events around the wrapper's call, the copy before it left
    out."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from cornell_moe_tpu_torch.ops import kernels

    k = k0.clone()
    for _ in range(2):
        k.copy_(k0)
        kernels.lml_chol_f64(k, y)
    torch.cuda.synchronize()
    calls = []
    for _ in range(reps):
        k.copy_(k0)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        kernels.lml_chol_f64(k, y)
        end.record()
        torch.cuda.synchronize()
        calls.append(start.elapsed_time(end))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            k.copy_(k0)
            kernels.lml_chol_f64(k, y)
            torch.cuda.synchronize()
    device = [ev.time_range.elapsed_us() / 1e3 for ev in prof.events()
              if ev.device_type == DeviceType.CUDA and
              "lml_chol_f64" in ev.name]
    check(2 * len(device) >= reps, f"the profiler recorded {len(device)} "
                                   f"of {reps} lml_chol_f64 launches")
    return {"device_ms": statistics.median(device),
            "call_ms": statistics.median(calls), "device_calls_seen":
            len(device)}


def phase_lml_chol(torch) -> list:
    """The tiled float64 Cholesky (kernels.lml_chol_f64) at the d-KG
    chain's shapes, K's side 1536 (512 points x 3 channels) with W = 8 (a
    half-step) and 16 (the chain's start), and at the value-only N 1008
    above kernel B's gate: against its plain version (rtol 1e-9, checked),
    its time beside its fp64_mma bound (cmoe_bench.roofline), the plain
    version's and the library's (cholesky_ex and one forward solve, the
    route the chain took before it: library_ms), each timed in turns.
    Returns its summary row (W 8, N 1536)."""
    from cmoe_bench import roofline

    from cornell_moe_tpu_torch.ops import kernels

    rows = []
    for w, np_, derivatives in ((8, 512, DKG_DERIVATIVES),
                                (16, 512, DKG_DERIVATIVES), (8, 1008, ())):
        y, k0 = _chol_system(torch, w, np_, derivatives, 2500 + w)
        n = k0.shape[-1]
        ref = kernels.lml_chol_plain(k0, y)
        got = kernels.lml_chol_f64(k0.clone(), y)
        errs = [((g - r).abs() / r.abs()).max().item()
                for g, r in zip(got, ref)]
        abs_err = max((g - r).abs().max().item() for g, r in zip(got, ref))
        ok = max(errs) < 1e-9 and all(g.dtype == torch.float64 for g in got)
        emit({"phase": "equivalence", "kernel": "lml_chol_f64", "W": w,
              "N": n, "max_abs_err": abs_err,
              "max_rel_err": {"quad": errs[0], "half_logdet": errs[1]},
              "tolerance": "rtol 1e-9 vs plain float64", "ok": ok})
        check(ok, f"lml_chol_f64 disagrees with its plain version at W={w}, "
                  f"N={n}")

        def library():
            chol = torch.linalg.cholesky_ex(k0)[0]
            return torch.linalg.solve_triangular(
                chol, y.expand(w, n)[..., None], upper=False)

        turns = {"kernel": [], "plain": [], "library": []}
        for name in ("plain", "library", "kernel", "kernel", "library",
                     "plain"):
            turns[name].append(
                _chol_kernel_ms(torch, k0, y, 20) if name == "kernel" else
                _timed(torch, library if name == "library" else
                       lambda: kernels.lml_chol_plain(k0, y), 20))
        t = {name: {key: statistics.mean(v[key] for v in runs)
                    for key in ("device_ms", "call_ms")}
             for name, runs in turns.items()}
        flop = w * n ** 3 / 3
        nbytes = 8 * (2 * w * n * (n + 1) // 2 + n + 2 * w)
        bound = roofline.bound64(nbytes, matmul=flop)
        emit({"phase": "lml_chol_timing", "W": w, "N": n, **t,
              "library_ms": t["library"]["device_ms"],
              "bound_ms": bound["ms"], "bound_pipe": bound["pipe"],
              "share_of_bound": bound["ms"] / t["kernel"]["device_ms"],
              "tflops": flop / t["kernel"]["device_ms"] / 1e9,
              "kernel_over_library_device": t["kernel"]["device_ms"] /
              t["library"]["device_ms"],
              "timing": "kernel: device_ms its CUDA events under "
                        "torch.profiler, call_ms CUDA events around the "
                        "wrapper, a fresh K each call; plain and library: "
                        + TIMING.format(20) + "; in turns plain, library, "
                        "kernel, kernel, library, plain; means of the "
                        "turns"})
        if (w, n) == (8, 1536):
            row = kernel_row("lml_chol_f64", None, abs_err, t["kernel"],
                             t["plain"], bound)
            row["library_ms"] = t["library"]["device_ms"]
            rows.append(row)
    return rows


def kernel_row(name, launches, err, times, plain, bound) -> dict:
    """One row of the kernels' summary line.  times, plain: the kernel's and
    its plain version's {"device_ms", "call_ms"} (:func:`_timed`); ms is the
    kernel's device time, and its share of the bound is bound / device_ms.
    bound: from ``cmoe_bench.roofline``.  No single PyTorch call computes
    any of these kernels' functions, so library_ms is null, but
    lml_chol_f64's (cuSOLVER's factor and a forward solve, filled by
    phase_lml_chol)."""
    source, replaces = SOURCES[name]
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": err, "ms": times["device_ms"],
            "device_ms": times["device_ms"], "call_ms": times["call_ms"],
            "plain_ms": plain["device_ms"],
            "plain_call_ms": plain["call_ms"],
            "bound_ms": bound["ms"], "bound_by": bound["by"],
            "bound_pipe": bound["pipe"],
            "share_of_bound": bound["ms"] / times["device_ms"],
            "library_ms": None}


def descent_bound(s, b, m, np_, d, q, kernel_name, evaluations,
                  direction_out=False):
    """A (or D, evaluations = 1), over s b m np_ evaluations (draw, training
    point) pairs: per pair 3d FP32 FLOP of distance and 6 of the field, the
    field's MUFU operations, and 2 Wr FLOP of the moment contraction (a
    matrix product); bytes of xs0, ws, wt, beta, z, us, geom in and the
    points (or directions) out.  On the bench's pipes and peaks
    (``cmoe_bench.roofline``), which bound no descent of their own."""
    from cmoe_bench import roofline
    wr = (1 + q) * (1 + d)
    pairs = s * b * m * np_ * evaluations
    floats = 2 * s * b * d * m + s * d * np_ + s * b * wr * np_ + \
        s * b * q * m + q * m + s * b * q * d + \
        (0 if direction_out else 3 * s * d)
    return roofline.bound(4 * floats, fp32=pairs * (3 * d + 6),
                          matmul=pairs * 2 * wr,
                          mufu=pairs * roofline.mufu_per_field(kernel_name))


def _time_ms(torch, fn, reps: int) -> float:
    """Median time between CUDA events recorded before and after a call of
    fn, over reps calls after one warm-up: the kernel's time plus the host
    work of its wrapper, during which the card may sit idle."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


DEVICE_MS_GAP_S = 0.02    # the card's idle time between two timed calls
DEVICE_MS_ATTEMPTS = 3    # profiled runs before a miscount fails the script


def _device_ms(torch, fn, reps: int) -> float:
    """Median over reps calls of fn of the card's time in the work each call
    launched: the sum of its CUDA events (kernels, copies, fills) under
    torch.profiler.  The wrapper's host work is left out, and a plain
    version's many small launches are summed.

    Calls are told apart on the device's own timeline: after each call a
    synchronize and DEVICE_MS_GAP_S of sleep leave the card idle, and the
    events split into calls wherever it sat idle for more than half of
    that (no call waits on its host for that long).  The profiler's host
    and device clocks disagree by up to a call's length on the H100, so
    host ranges cannot place device events.  One warm-up call runs under
    the profiler first.  The profiler may leave a call's events unrecorded:
    the first kernel after it starts, on the H100 at times the last one
    before it stops too, in one whole run of this script 12 of 21 calls,
    and once every call of a profiled run.  So only the calls whose event
    count is the most common one (whole calls) are read, the last reps of
    them; when fewer than half the calls made are whole, or none was seen,
    the profiled run is made again, up to
    DEVICE_MS_ATTEMPTS times, and each such run prints a
    ``device_ms_miscount`` line with what the profiler saw."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    calls, whole = [], []
    for attempt in range(1, DEVICE_MS_ATTEMPTS + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps + 1):
                fn()
                torch.cuda.synchronize()
                time.sleep(DEVICE_MS_GAP_S)
        spans = sorted((ev.time_range.start, ev.time_range.end)
                       for ev in prof.events()
                       if ev.device_type == DeviceType.CUDA)
        if not spans:
            emit({"phase": "device_ms_miscount", "attempt": attempt,
                  "calls_made": reps + 1, "calls_seen": 0,
                  "device_events": 0})
            continue
        calls, last_end = [[]], spans[0][0]
        for start, end in spans:                # microseconds
            if start - last_end > DEVICE_MS_GAP_S * 1e6 / 2:
                calls.append([])
            calls[-1].append(end - start)
            last_end = max(last_end, end)
        counts = [len(c) for c in calls]
        mode = max(set(counts), key=counts.count)
        whole = [c for c in calls if len(c) == mode]
        if len(calls) <= reps + 1 and 2 * len(whole) > reps + 1:
            return statistics.median(sum(c) / 1e3 for c in whole[-reps:])
        emit({"phase": "device_ms_miscount", "attempt": attempt,
              "calls_made": reps + 1, "calls_seen": len(calls),
              "device_events": len(spans), "events_per_call": counts,
              "longest_event_us": max(e - s for s, e in spans),
              "timeline_us": spans[-1][1] - spans[0][0]})
    check(False, f"{len(calls)} calls seen on the device ({len(whole)} "
                 f"whole), {reps + 1} made, in each of {DEVICE_MS_ATTEMPTS} "
                 "profiled runs")


def _timed(torch, fn, reps: int) -> dict:
    """fn's device time (:func:`_device_ms`) and its call time between
    CUDA events (:func:`_time_ms`), each the median of reps calls."""
    return {"device_ms": _device_ms(torch, fn, reps),
            "call_ms": _time_ms(torch, fn, reps)}


TIMING = ("device_ms: the sum of the call's CUDA events under "
          "torch.profiler; call_ms: CUDA events around the call, wrapper "
          "included; each the median of {} calls after a warm-up")


def phase_equivalence(torch, model, counts, counts_768):
    """Each kernel of the main path against its plain version on the card,
    in float32, at the main path's shapes, and kernel B's large-Np
    instance at LML_LARGE_NPS.  The summary rows' launches are the main
    path's (``counts``), the large-Np instance's main_path_768's
    (``counts_768``).  Returns the kernels' summary rows and the descent
    problems, [(label, problem)]."""
    from cmoe_bench import roofline
    from cornell_moe_tpu_torch.models import mcmc as mcmc_mod
    from cornell_moe_tpu_torch.ops import kernels
    from cornell_moe_tpu_torch.ops.domains import TensorProductDomain

    dev = model.device
    g = torch.Generator(device=dev).manual_seed(1234)
    states = model.models
    x, y, pn = model._padded_data()
    rows = []

    def row(name, err, times, plain, bound):
        rows.append(kernel_row(name, counts.get(name, 0), err, times, plain,
                               bound))

    # --- C: covariance + noise, S = 16, n = 512 ------------------------------
    # Against the plain version, and K symmetric bit for bit: the kernel
    # computes each off-diagonal tile once and writes it twice.
    h = states.covariance.hyperparameters
    nv = states.noise_variance + states.point_noise[..., 0]
    fields, ok, call, plain = _covariance_case(torch, x, h, nv,
                                               model.kernel_name)
    times = _timed(torch, call, 20)
    emit({"phase": "equivalence", **fields, **times})
    check(ok, "covariance_with_noise disagrees with its plain version or "
              "is not symmetric")
    row("covariance_with_noise", fields["max_abs_err"], times,
        _timed(torch, plain, 20),
        roofline.covariance_bound(h.shape[0], x.shape[0], x.shape[1],
                                  model.kernel_name))

    # --- B: fused LML, W = 8 and 16 walkers, Np = 512 and 384 ---------------
    # The chain's stretch move evaluates one half-ensemble (W = 8) per
    # launch, its starts the whole ensemble (W = 16).  Walker
    # hyperparameters drawn as tests/test_pallas_descent.py:131-150 draws
    # them (well-conditioned K), in the domain's units; the chain's own
    # walkers are held to the log-posterior check below.  The cluster
    # instance (which the wrapper takes at these Np) against the plain
    # version, and against the large-Np instance on the same inputs.
    w, d = model.n_hypers, model.dim
    f32 = dict(device=dev, dtype=torch.float32)
    dom = kg_domain(dev, torch.float32)
    width = dom.upper - dom.lower
    lengths = (0.3 + 0.4 * torch.rand((w, d), generator=g, **f32)) * width
    alphas = 0.8 + torch.rand((w,), generator=g, **f32)
    noises = 1e-2 + 1e-2 * torch.rand((w, 1), generator=g, **f32)
    lml_errs, times = [], {}

    def rel(a, b):
        return ((a.double() - b.double()).abs() /
                b.double().abs().clamp_min(1.0)).max().item()

    for nw in (w // 2, w):
        for np_ in (x.shape[0], min(384, x.shape[0])):
            check(kernels.lml_fused_instance(np_) == "cluster",
                  f"Np={np_} does not take the cluster instance")
            xs, ys = x[:np_].float(), y[:np_, 0].float()
            us = (xs.T[None] / lengths[:nw, :, None]).contiguous()
            noise = (noises[:nw] + pn[None, :np_, 0]).contiguous()
            yb = ys[None].expand(nw, np_).contiguous()
            largs = (us, alphas[:nw].contiguous(), noise, yb, np_,
                     model.kernel_name)
            quad, logdet = kernels.lml_fused(*largs)
            quad_g, logdet_g = kernels.lml_fused_global(*largs)
            quad_p, logdet_p = kernels.lml_fused_plain(*largs)
            quad_64, logdet_64 = kernels.lml_fused_plain(
                *[a.double() for a in largs[:4]], np_, model.kernel_name)
            abs_err = max((quad - quad_p).abs().max().item(),
                          (logdet - logdet_p).abs().max().item())
            errs = {"quad": rel(quad, quad_p),
                    "logdet": rel(logdet, logdet_p),
                    "kernel_vs_f64": max(rel(quad, quad_64),
                                         rel(logdet, logdet_64)),
                    "plain_vs_f64": max(rel(quad_p, quad_64),
                                        rel(logdet_p, logdet_64)),
                    "kernel_vs_large_np_instance": max(
                        rel(quad, quad_g), rel(logdet, logdet_g))}
            bitwise = bool(torch.equal(quad, quad_g) and
                           torch.equal(logdet, logdet_g))
            ok = errs["quad"] < 5e-4 and errs["logdet"] < 5e-4 and \
                errs["kernel_vs_large_np_instance"] < 1e-6
            emit({"phase": "equivalence", "kernel": "lml_fused",
                  "instance": "cluster", "W": nw, "Np": np_,
                  "max_abs_err": abs_err, "max_rel_err": errs,
                  "bitwise_equal_to_large_np_instance": bitwise,
                  "tolerance": "rtol 5e-4 vs plain, rtol 1e-6 vs the "
                               "large-Np instance", "ok": ok})
            check(ok, f"lml_fused disagrees at W={nw}, Np={np_}")
            lml_errs.append(abs_err)
            if np_ == x.shape[0]:
                times[nw] = {
                    "cluster": _timed(
                        torch, lambda: kernels.lml_fused(*largs), 20),
                    "large_np_instance": _timed(
                        torch, lambda: kernels.lml_fused_global(*largs), 20),
                    "plain": _timed(
                        torch, lambda: kernels.lml_fused_plain(*largs), 20)}
                emit({"phase": "lml_fused_timing", "W": nw, "Np": np_,
                      **times[nw], "timing": TIMING.format(20)})
    # B's large-Np instance where it serves alone (above the cluster
    # capacity): W = 8 and 16 at each of LML_LARGE_NPS, points drawn in the
    # domain, against the plain version (rtol 5e-4, checked) and float64
    # (reported), both timed in turns in this call (plain, kernel, kernel,
    # plain); at 1008, above the gate, the times are reported for a later
    # opening of the gate on this evidence.  The first case draws its points
    # from g, as the one case before it did, the others from their own
    # generator, so the descent problems below see g's same draws.
    large, g_large = {}, torch.Generator(device=dev).manual_seed(1235)
    for nw in (w // 2, w):
        for np_ in LML_LARGE_NPS:
            check(kernels.lml_fused_instance(np_) == "global",
                  f"Np={np_} does not take the large-Np instance")
            gen = g if not large else g_large
            xs = dom.lower + torch.rand((np_, d), generator=gen, **f32) * \
                width
            us = (xs.T[None] / lengths[:nw, :, None]).contiguous()
            noise = noises[:nw].expand(nw, np_).contiguous()
            yb = torch.randn((np_,), generator=gen, **f32)[None].expand(
                nw, np_).contiguous()
            largs = (us, alphas[:nw].contiguous(), noise, yb, np_,
                     model.kernel_name)
            quad_g, logdet_g = kernels.lml_fused_global(*largs)
            quad_p, logdet_p = kernels.lml_fused_plain(*largs)
            quad_64, logdet_64 = kernels.lml_fused_plain(
                *[a.double() for a in largs[:4]], np_, model.kernel_name)
            abs_err = max((quad_g - quad_p).abs().max().item(),
                          (logdet_g - logdet_p).abs().max().item())
            errs = {"quad": rel(quad_g, quad_p),
                    "logdet": rel(logdet_g, logdet_p),
                    "kernel_vs_f64": max(rel(quad_g, quad_64),
                                         rel(logdet_g, logdet_64)),
                    "plain_vs_f64": max(rel(quad_p, quad_64),
                                        rel(logdet_p, logdet_64))}
            ok = errs["quad"] < 5e-4 and errs["logdet"] < 5e-4
            emit({"phase": "equivalence", "kernel": "lml_fused",
                  "instance": "large_np", "W": nw, "Np": np_,
                  "max_abs_err": abs_err, "max_rel_err": errs,
                  "tolerance": "rtol 5e-4 vs plain (f64: reported)",
                  "ok": ok})
            check(ok, f"lml_fused_global disagrees at W={nw}, Np={np_}")
            t = _in_turns(torch, {
                "large_np_instance":
                    lambda: kernels.lml_fused_global(*largs),
                "plain": lambda: kernels.lml_fused_plain(*largs)},
                ("plain", "large_np_instance", "large_np_instance",
                 "plain"), 20)
            bound = roofline.lml_bound(nw, np_, d, model.kernel_name)
            large[(nw, np_)] = (abs_err, t, bound)
            emit({"phase": "lml_fused_timing", "W": nw, "Np": np_, **t,
                  "kernel_over_plain_device":
                      t["large_np_instance"]["device_ms"] /
                      t["plain"]["device_ms"],
                  "bound_ms": bound["ms"],
                  "gate": "open" if np_ <= mcmc_mod.LML_MAX_OBS else
                          "closed (plain LML)",
                  "timing": TIMING.format(20) + ", in turns plain, "
                            "kernel, kernel, plain; means of the turns"})
    # B's float64 instance, which a float64 model's chain launches (the
    # benchmark's cell): at the main path's Np 512, where float64 takes the
    # large-Np instance, W = 8 and 16 on the main path's points, against
    # the plain version in float64 (rtol 1e-10, checked), both timed in
    # turns; its summary row at W 8 with the float64 bound
    # (cmoe_bench.roofline) and no launches (no float64 path runs here).
    np_ = x.shape[0]
    check(kernels.lml_fused_instance(np_, 8) == "global",
          f"float64 at Np={np_} does not take the large-Np instance")
    for nw in (w // 2, w):
        us = (x.T[None].double() /
              lengths[:nw, :, None].double()).contiguous()
        noise = (noises[:nw].double() + pn[None, :, 0].double()).contiguous()
        yb = y[None, :, 0].double().expand(nw, np_).contiguous()
        largs = (us, alphas[:nw].double().contiguous(), noise, yb, np_,
                 model.kernel_name)
        got = kernels.lml_fused(*largs)
        ref = kernels.lml_fused_plain(*largs)
        errs = {"quad": rel(got[0], ref[0]), "logdet": rel(got[1], ref[1])}
        abs_err = max((a - b).abs().max().item() for a, b in zip(got, ref))
        ok = max(errs.values()) < 1e-10 and all(
            g.dtype == torch.float64 for g in got)
        emit({"phase": "equivalence", "kernel": "lml_fused",
              "instance": "large_np_f64", "W": nw, "Np": np_,
              "max_abs_err": abs_err, "max_rel_err": errs,
              "tolerance": "rtol 1e-10 vs plain float64", "ok": ok})
        check(ok, f"lml_fused float64 disagrees at W={nw}, Np={np_}")
        t = _in_turns(torch, {
            "large_np_instance_f64": lambda: kernels.lml_fused(*largs),
            "plain_f64": lambda: kernels.lml_fused_plain(*largs)},
            ("plain_f64", "large_np_instance_f64", "large_np_instance_f64",
             "plain_f64"), 20)
        bound = roofline.lml_bound(nw, np_, d, model.kernel_name, "float64")
        emit({"phase": "lml_fused_timing", "W": nw, "Np": np_,
              "dtype": "float64", **t,
              "kernel_over_plain_device":
                  t["large_np_instance_f64"]["device_ms"] /
                  t["plain_f64"]["device_ms"],
              "bound_ms": bound["ms"], "bound_pipe": bound["pipe"],
              "timing": TIMING.format(20) + ", in turns plain, "
                        "kernel, kernel, plain; means of the turns"})
        if nw == w // 2:
            rows.append(kernel_row("lml_fused_global_f64", None, abs_err,
                                   t["large_np_instance_f64"],
                                   t["plain_f64"], bound))
    # the summary row: W 8 at Np 768, the main_path_768 chain's first
    # shape, with that path's launches
    abs_err, t, bound = large[(w // 2, MAIN_768_OBS)]
    rows.append(kernel_row("lml_fused_global",
                           counts_768.get("lml_fused_global", 0), abs_err,
                           t["large_np_instance"], t["plain"], bound))
    np_main = x.shape[0]
    smem = kernels._lib().cmoe_lml_fused_cluster_smem_bytes(np_main)
    occupancy = {f"W{nw}_C{c}": kernels.lml_cluster_occupancy(nw, np_main, c)
                 for nw in (w // 2, w) for c in (kernels.LML_CLUSTER, 16)}
    lib = kernels._lib()
    global_layout = {
        np_: {"smem_bytes_per_cta": lib.cmoe_lml_fused_global_smem_bytes(
                  np_),
              "scratch_bytes_per_walker":
                  4 * lib.cmoe_lml_fused_global_scratch_floats(np_),
              "max_active_clusters": {
                  f"W{nw}": kernels.lml_global_occupancy(nw, np_)
                  for nw in (w // 2, w)}}
        for np_ in LML_LARGE_NPS}
    emit({"phase": "lml_fused_cluster", "Np": np_main,
          "cluster": kernels.LML_CLUSTER,
          "smem_bytes_per_cta": smem,
          "smem_bytes_per_cta_C16": kernels.lml_cluster_smem_bytes(np_main,
                                                                    16),
          "capacity_np": kernels.LML_CLUSTER_CAPACITY,
          "max_active_clusters": occupancy,
          "large_np_instance": global_layout})
    check(smem == kernels.lml_cluster_smem_bytes(np_main),
          "the kernel's shared-memory layout differs from the wrapper's")
    check(all(v["smem_bytes_per_cta"] == kernels.lml_global_smem_bytes(np_)
              and v["scratch_bytes_per_walker"] ==
              4 * kernels.lml_global_scratch_floats(np_)
              for np_, v in global_layout.items()),
          "the large-Np instance's layout differs from the wrapper's")
    # the model's log-posterior at the chain's walkers, on the bench's
    # retrain problem (bench.py:297-315) and at the main path's walkers
    for label, m in (("bench_retrain_problem", bench_retrain_model(torch)),
                     ("main_path_walkers", model)):
        _log_posterior_check(torch, label, m)
    row("lml_fused", max(lml_errs), times[w // 2]["cluster"],
        times[w // 2]["plain"], roofline.lml_bound(w // 2, x.shape[0], d,
                                                   model.kernel_name))

    # --- A: KG inner descent, S=16, B=200, q=4, d=2, M=128, Np=512 -----------
    # Both instances: the tensor-core one (descent_run, the main path's)
    # and the FMA one (descent_run_fma).  On the bench's suggest problem
    # (bench.py:50-80) and on the main path's own ensemble.  A few descents
    # in a thousand sit where float32 rounding flips a clamped step (the
    # steps are capped at 0.1 x the distance to the wall, so the sign of a
    # near-zero gradient decides them), and there any two float32
    # evaluation orders part ways.  So each instance is held to the float64
    # descent: at every quantile of the 409,600 endpoints' deviation (in
    # domain-width units) it must be within 5e-5
    # (tests/test_pallas_descent.py:64-65) or within 1.5x the float32 plain
    # version's own deviation.
    errs = {"descent_run": [], "descent_run_fma": []}
    problems = []
    for label, st, box in (("bench_suggest_problem",
                            bench_suggest_states(torch), "unit"),
                           ("main_path_ensemble", states, "branin")):
        bdom = kg_domain(dev, torch.float32) if box == "branin" else \
            TensorProductDomain.from_bounds([[0.0, 1.0]] * 2, device=dev,
                                            dtype=torch.float32)
        pb = _descent_problem(torch, st, bdom, g)
        problems.append((label, pb))
        for params_label, got, p32, p64 in _descent_case(
                torch, pb, model.kernel_name):
            p64q = _quantiles(torch, (p32 - p64).abs())
            result, ok = {}, True
            for name, k in got.items():
                k64 = _quantiles(torch, (k - p64).abs())
                ok_i = all(k64[q] <= max(5e-5, 1.5 * p64q[q]) for q in k64)
                err = ((k - p32) * pb["width"]).abs().max().item()
                result[name] = {"max_abs_err": err,
                                "kernel_vs_plain_f64": k64,
                                "kernel_vs_plain_f32": _quantiles(
                                    torch, (k - p32).abs()),
                                "ok": ok_i}
                errs[name].append(err)
                ok = ok and ok_i
            emit({"phase": "equivalence", "kernel": "descent_run",
                  "state": label, "params": params_label,
                  "shape": [st.chol_K.shape[0], MULTISTARTS, 2, NUM_MC],
                  "instances": result, "plain_f32_vs_f64": p64q,
                  "mma_vs_fma": _quantiles(
                      torch, (got["descent_run"] -
                              got["descent_run_fma"]).abs()),
                  "tolerance": "per quantile, kernel vs f64 <= max(5e-5, "
                               "1.5 x plain f32 vs f64), domain-width units",
                  "ok": ok})
            check(ok, f"descent_run ({label}, {params_label}): an instance "
                      "is less accurate than the plain version")
    times = _descent_timing(torch, problems[0][1], model.kernel_name)
    for name in errs:
        row(name, max(errs[name]), times["times"][name], times["plain"],
            times["bound"])
    return rows, problems


def _finite_or_none(t):
    """Max of t as a float, None when it is not finite (JSON has no inf)."""
    v = t.max().item()
    return v if math.isfinite(v) else None


def _quantiles(torch, d):
    d = d.flatten().double()
    qs = torch.quantile(d, torch.tensor([0.5, 0.9, 0.99, 0.999],
                                        dtype=torch.float64,
                                        device=d.device)).tolist()
    return {"q50": qs[0], "q90": qs[1], "q99": qs[2], "q999": qs[3],
            "max": d.max().item()}


def _descent_problem(torch, states, dom, g) -> dict:
    """The KG inner descent's operands at the main path's shapes (S
    members, B = 200 unions, q = 4, M = 128 draws, d = 2) for one ensemble:
    random unions, antithetic normals, the fantasy model's v and betas,
    random starts x0 (S, B, M, d) in the domain and the kernels' packed
    operands in scaled coordinates."""
    from cornell_moe_tpu_torch.acquisition import knowledge_gradient as kg
    from cornell_moe_tpu_torch.acquisition.expected_improvement import (
        draw_antithetic_normals)
    from cornell_moe_tpu_torch.bayes_opt import DEFAULT_SGD_PARAMS_PS
    from cornell_moe_tpu_torch.ops import linalg

    f32 = dict(device=dom.bounds.device, dtype=torch.float32)
    s = states.chol_K.shape[0]
    unions = dom.generate_uniform_random_points_in_domain(
        g, MULTISTARTS * Q).reshape(MULTISTARTS, Q, 2)
    normals = draw_antithetic_normals(g, NUM_MC, Q, **f32)
    _, chol_u, v, _ = kg._build_fantasy_model_batch(states, unions)
    betas = linalg.solve_triangular_small(
        chol_u, normals.T.expand(s, MULTISTARTS, Q, NUM_MC),
        trans=True).transpose(-1, -2)
    x0 = dom.generate_uniform_random_points_in_domain(
        g, s * MULTISTARTS * NUM_MC).reshape(s, MULTISTARTS, NUM_MC, 2)
    v, betas = v.detach(), betas.detach()
    lengths = states.covariance.lengths.double()
    warm = kg.dataclasses.replace(DEFAULT_SGD_PARAMS_PS, max_num_steps=1,
                                  max_num_restarts=1, num_steps_averaged=0)
    return {
        "states": states, "dom": dom, "unions": unions, "normals": normals,
        "v": v, "betas": betas, "x0": x0, "lengths": lengths,
        "ops": kg._pack_descent_inputs(states, unions, v, betas, normals),
        "geom": torch.stack([dom.lower / lengths, dom.upper / lengths,
                             1.0 / lengths**2], dim=1).float().contiguous(),
        "xs0": (x0 / lengths[:, None, None, :]).transpose(-1, -2).float(
        ).contiguous(),
        "width": (dom.upper - dom.lower).double(),
        "params": (("cold", DEFAULT_SGD_PARAMS_PS), ("warm", warm)),
        "endpoints": {}}


def _descent_case(torch, pb, kernel_name):
    """Kernel A's two instances, the plain float32 and the plain float64
    descents on one descent problem, cold and warm parameters.  Keeps the
    tensor-core instance's, plain float32 and plain float64 endpoints (S, B,
    M, d), in domain-width units, in pb["endpoints"][params] and each
    call's arguments in pb["dargs"][params].  Yields (params, {instance:
    endpoints}, plain f32, plain f64)."""
    from cornell_moe_tpu_torch.ops import kernels

    lengths, width = pb["lengths"], pb["width"]
    pb["dargs"] = {}

    def to_unit(xs):
        return xs.double().transpose(-1, -2) * lengths[:, None, None, :] / \
            width

    for label, params in pb["params"]:
        steps = params.max_num_steps
        avg_n = params.num_steps_averaged if \
            0 < params.num_steps_averaged <= steps else 0
        tail = (kernel_name, steps, params.max_num_restarts, avg_n,
                params.gamma, params.pre_mult, params.max_relative_change)
        dargs = (pb["xs0"], *pb["ops"], pb["geom"], *tail)
        got = {"descent_run": to_unit(kernels.descent_run(*dargs)),
               "descent_run_fma": to_unit(kernels.descent_run_fma(*dargs))}
        p32 = to_unit(kernels.descent_run_plain(*dargs))
        p64 = to_unit(kernels.descent_run_plain(
            *[a.double() for a in (pb["xs0"], *pb["ops"], pb["geom"])],
            *tail))
        pb["endpoints"][label] = (got["descent_run"], p32, p64)
        pb["dargs"][label] = dargs
        yield label, got, p32, p64


def _in_turns(torch, fns: dict, order, reps: int) -> dict:
    """Each of fns ({name: fn}) timed by :func:`_timed` in turns, in the
    given order (fma, mma, mma, fma: a drift of the card's clock over the
    turns falls on both alike).  Returns {name: {"device_ms", "call_ms":
    the means over the name's turns, "turns": each turn's}}."""
    turns = {n: {"device_ms": [], "call_ms": []} for n in fns}
    for n in order:
        for k, v in _timed(torch, fns[n], reps).items():
            turns[n][k].append(v)
    return {n: {**{k: statistics.mean(v) for k, v in t.items()},
                "turns": t} for n, t in turns.items()}


def _descent_timing(torch, pb, kernel_name) -> dict:
    """Kernel A's two instances timed in turns (fma, mma, mma, fma; each
    turn :func:`_timed` over 20 calls) at the cold and warm schedules of
    one descent problem, beside the bound of the work and each pipe's time
    under it; the plain version once per schedule (5 calls).  Returns the
    cold times ({instance: times}), plain times and bound for the kernels'
    summary."""
    from cornell_moe_tpu_torch.ops import kernels

    out = {}
    for label, dargs in pb["dargs"].items():
        times = _in_turns(
            torch, {n: (lambda fn=getattr(kernels, n): fn(*dargs))
                    for n in ("descent_run_fma", "descent_run")},
            ("descent_run_fma", "descent_run", "descent_run",
             "descent_run_fma"), 20)
        s, b, d, m = dargs[0].shape
        np_, q = dargs[1].shape[-1], dargs[4].shape[0]
        evaluations = dargs[8] * dargs[9]
        bound = descent_bound(s, b, m, np_, d, q, kernel_name, evaluations)
        rec = {"phase": "descent_run_timing", "params": label,
               "shape": [s, b, d, m, np_], "field_evaluations": evaluations,
               **times, "bound_ms": bound["ms"], "bound_pipe": bound["pipe"],
               "bound_pipes_ms": bound["pipes_ms"],
               "share_of_bound": {n: bound["ms"] / t["device_ms"]
                                  for n, t in times.items()},
               "mma_blocks_per_sm": kernels.descent_mma_occupancy(
                   d, q, m, np_, kernel_name),
               "plain": _timed(
                   torch, lambda: kernels.descent_run_plain(*dargs), 5),
               "timing": "in turns fma, mma, mma, fma; per turn " +
                         TIMING.format(20) + "; plain: " + TIMING.format(5)}
        if label == "cold":
            out = {"times": times, "bound": bound, "plain": rec["plain"]}
        emit(rec)
    return out


def phase_descent_grad(torch, kernel_name, problems) -> list:
    """Kernel D and the per-step route it serves (``_descent_grad_bvg``
    driven by ``optimizers.gradient_ascent_batch``) on the descent problems
    of phase_equivalence.

    (a) One direction at the starts against the float64 plain version: no
    further than 2e-5 max(max|g|, 1) (tests/test_pallas_descent.py:48) or
    1.5x the float32 plain version's own deviation; and against the float32
    plain version within that bound wherever the float32 plain version is
    itself within it of float64.  (g = x s0 - sx cancels: with |x s0| near
    180 at |g| near 8, the plain version's float32 sums land 1.8e-4 from
    float64 on a slice of the bench's problem, above the bound of 1.6e-4.)
    Both instances of D, the tensor-core one (descent_grad, which the
    wrapper takes at these shapes) and the FMA one (descent_grad_fma), are
    held to this rule.  (b) The route, cold and warm, against the float64
    descent by A's per-quantile rule.  (c) Each route run launches the
    tensor-core instance steps x restarts times and no other kernel.  (d)
    Times: D's two instances in turns (fma, mma, mma, fma) and its plain
    version per launch, the whole route against one descent_run launch
    (:func:`_timed`, 20 calls each).  Returns D's two summary rows."""
    from cornell_moe_tpu_torch.acquisition import knowledge_gradient as kg
    from cornell_moe_tpu_torch.ops import kernels, optimizers

    names = ("descent_grad", "descent_grad_fma")
    errs = {n: [] for n in names}
    launches = dict.fromkeys(names, 0)
    times = None
    for label, pb in problems:
        xs0, ops = pb["xs0"], pb["ops"]
        check(kernels.descent_grad_instance(xs0.shape[2], ops[3].shape[0],
                                            ops[0].shape[-1]) == "mma",
              "the main path's shapes do not take D's tensor-core instance")
        p32 = kernels.descent_grad_plain(xs0, *ops, kernel_name)
        p64 = kernels.descent_grad_plain(
            *[a.double() for a in (xs0, *ops)], kernel_name)
        # compared where the float64 direction is finite; where it is not,
        # the operands are (a fantasy factor that float32 could not form),
        # and the kernel must be non-finite there too
        fin = torch.isfinite(p64)
        both = fin & torch.isfinite(p32)
        g_max = _finite_or_none(p64[fin].abs())
        bound = 2e-5 * max(g_max or 0.0, 1.0)
        dev_p = (p32.double() - p64)[both].abs().max().item()
        result, got, ok = {}, {}, g_max is not None
        for name in names:
            got[name] = getattr(kernels, name)(xs0, *ops, kernel_name)
            k = got[name]
            err = (k - p32)[both].abs().max().item()
            dev_k = _finite_or_none((k.double() - p64)[fin].abs())
            ok_i = dev_k is not None and \
                bool((torch.isfinite(k) == fin).all()) and \
                dev_k <= max(bound, 1.5 * dev_p) and (err <= bound or
                                                      dev_p > bound)
            result[name] = {"max_abs_err": err, "kernel_vs_plain_f64": dev_k,
                            "nonfinite": int((~torch.isfinite(k)).sum()),
                            "ok": ok_i}
            errs[name].append(err)
            ok = ok and ok_i
        emit({"phase": "equivalence", "kernel": "descent_grad",
              "check": "direction", "state": label,
              "shape": list(p32.shape), "instances": result,
              "nonfinite": {"plain_f32": int((~torch.isfinite(p32)).sum()),
                            "plain_f64": int((~fin).sum())},
              "nonfinite_operands": {
                  n: int((~torch.isfinite(a)).sum()) for n, a in
                  zip(("xs", "ws", "wt", "beta", "z", "us"), (xs0, *ops))},
              "max_abs_g": g_max, "plain_f32_vs_f64": dev_p,
              "mma_vs_fma": _finite_or_none(
                  (got["descent_grad"] - got["descent_grad_fma"])[
                      both].abs()),
              "bound": bound,
              "tolerance": "vs f64 <= max(bound, 1.5 x plain f32 vs f64); "
                           "vs plain f32 <= bound where plain f32 vs f64 <= "
                           "bound; bound = 2e-5 max(max|g|, 1)", "ok": ok})
        check(ok, f"descent_grad ({label}): an instance disagrees with the "
                  "plain version")
        del got, p32, p64
        if times is None:
            times = _in_turns(
                torch, {n: (lambda fn=getattr(kernels, n):
                            fn(xs0, *ops, kernel_name)) for n in names},
                ("descent_grad_fma", "descent_grad", "descent_grad",
                 "descent_grad_fma"), 20)
            times["plain"] = _timed(torch, lambda: kernels.descent_grad_plain(
                xs0, *ops, kernel_name), 20)
            emit({"phase": "descent_grad_timing", "state": label, **times,
                  "timing": "in turns fma, mma, mma, fma; per turn " +
                            TIMING.format(20)})

        for params_label, params in pb["params"]:
            bvg = kg._descent_grad_bvg(pb["states"], pb["unions"], pb["v"],
                                       pb["betas"], pb["normals"],
                                       kernel_name)
            torch.cuda.synchronize()
            before = snapshot()
            x = optimizers.gradient_ascent_batch(bvg, pb["dom"], pb["x0"],
                                                 params)
            torch.cuda.synchronize()
            counts = kernel_launches(before)
            expected = params.max_num_steps * max(params.max_num_restarts, 1)
            route = x.double() / pb["width"]
            k_a, p32e, p64e = pb["endpoints"][params_label]
            r64 = _quantiles(torch, (route - p64e).abs())
            pp64 = _quantiles(torch, (p32e - p64e).abs())
            launched_ok = counts == {"descent_grad": expected} and \
                expected > 0
            ok = launched_ok and all(r64[k] <= max(5e-5, 1.5 * pp64[k])
                                     for k in r64)
            emit({"phase": "equivalence", "kernel": "descent_grad",
                  "check": "route", "state": label, "params": params_label,
                  "shape": list(x.shape), "launches": counts,
                  "expected_launches": expected,
                  "route_vs_plain_f64": r64, "plain_f32_vs_f64": pp64,
                  "route_vs_descent_run": _quantiles(torch,
                                                     (route - k_a).abs()),
                  "tolerance": "per quantile, route vs f64 <= max(5e-5, "
                               "1.5 x plain f32 vs f64), domain-width units",
                  "ok": ok})
            check(launched_ok, f"the route ({label}, {params_label}) did not "
                               "launch descent_grad steps x restarts times")
            check(ok, f"the descent_grad route ({label}, {params_label}) is "
                      "less accurate than the plain float32 descent")
            for n in names:
                launches[n] += counts.get(n, 0)
            if label == problems[0][0] and params_label == "cold":
                emit({"phase": "descent_grad_route_timing", "state": label,
                      "params": params_label,
                      "route": _timed(
                          torch, lambda: optimizers.gradient_ascent_batch(
                              bvg, pb["dom"], pb["x0"], params), 20),
                      "descent_run": _timed(
                          torch, lambda: kernels.descent_run(
                              *pb["dargs"]["cold"]), 20),
                      "timing": TIMING.format(20)})
    s, b, d, m = problems[0][1]["xs0"].shape
    wt = problems[0][1]["ops"][1]
    bound = descent_bound(s, b, m, wt.shape[-1], d, (wt.shape[2] // (1 + d))
                          - 1, kernel_name, 1, direction_out=True)
    return [kernel_row(n, launches[n], max(errs[n]), times[n],
                       times["plain"], bound) for n in names]


def bench_problem_data():
    """The bench's data (bench.py:54-69): 500 points in the unit box,
    standardized Branin values plus 0.01 noise."""
    import numpy as np
    rng = np.random.default_rng(0)
    x = rng.random((NUM_OBS, 2))
    p0, p1 = x[:, 0] * 15.0, x[:, 1] * 20.0 - 5.0
    y = ((p1 - 5.1 / (4 * np.pi**2) * p0**2 + 5.0 / np.pi * p0 - 6.0) ** 2
         + 10.0 * (1 - 1.0 / (8 * np.pi)) * np.cos(p0) + 10.0)
    y = (y - y.mean()) / y.std() + 0.01 * rng.standard_normal(NUM_OBS)
    return rng, x, y


def bench_suggest_states(torch):
    """The bench's suggest ensemble (bench.py:70-79), bucketed to 512."""
    import numpy as np
    from cornell_moe_tpu_torch.models import mcmc
    rng, x, y = bench_problem_data()
    hypers = np.stack([0.5 + 1.5 * rng.random(N_HYPERS),
                       0.2 + 0.4 * rng.random(N_HYPERS),
                       0.2 + 0.4 * rng.random(N_HYPERS)], axis=1)
    f32 = dict(device=DEVICE, dtype=torch.float32)
    return mcmc.fit_gp_ensemble(
        "matern_2.5", torch.as_tensor(hypers, **f32),
        torch.full((N_HYPERS, 1), 1e-2, **f32), x, y[:, None], jitter=1e-5,
        bucket=16)


def bench_retrain_model(torch):
    """The retrain problem of bench.py:247-263 on the bench's data: 16
    walkers after burn-in and the gated chain, float32 on the card."""
    from cornell_moe_tpu_torch.models.mcmc import \
        GaussianProcessLogLikelihoodMCMC
    from cornell_moe_tpu_torch.utils.data_containers import HistoricalData

    _, x, y = bench_problem_data()
    hist = HistoricalData(2)
    hist.append_historical_data(x, y[:, None])
    model = GaussianProcessLogLikelihoodMCMC(
        hist, chain_length=1000, burnin_steps=2000, n_hypers=N_HYPERS,
        noisy=True, chain_gate_tol=1.0, bucket=16, device=DEVICE,
        dtype=torch.float32,
        generator=torch.Generator(device=DEVICE).manual_seed(0))
    model.train()
    return model


def kg_domain(dev, dtype):
    import numpy as np
    from cornell_moe_tpu_torch.ops.domains import TensorProductDomain
    from cornell_moe_tpu_torch.utils.synthetic_functions import Branin
    return TensorProductDomain.from_bounds(
        np.asarray(Branin()._search_domain), device=dev, dtype=dtype)


def _twin_never(torch, make_bo) -> dict:
    """The iteration of a path's driver (``make_bo()``) again with
    ``programs.CAPTURE = "never"``, every stage eager: what the comparison
    with the programs' run reads."""
    from cornell_moe_tpu_torch.ops import programs
    programs.CAPTURE = "never"
    try:
        bo = make_bo()
        rec = bo.run(num_iterations=1, num_init_pts=NUM_OBS)[-1]
        torch.cuda.synchronize()
    finally:
        programs.CAPTURE = "auto"
    check(len(bo.program_cache) == 0, "CAPTURE = 'never' built programs")
    out = {k: rec[k] for k in ("suggested", "voi", "recommended")}
    out["chain_steps"] = list(bo.model.chain_steps)
    out["stages"] = {r["phase"]: r["seconds"] for r in bo.timer.records}
    release(torch, bo)
    return out


def _programs_vs_never(torch, bo, rec, make_bo) -> dict:
    """A path's programs by kind and whether its results equal bit for bit
    those of its CAPTURE = "never" twin (:func:`_twin_never`)."""
    import numpy as np
    from cornell_moe_tpu_torch.ops import programs
    by_kind = programs.by_kind(bo.program_cache)
    never = _twin_never(torch, make_bo)
    got = {k: rec[k] for k in ("suggested", "voi", "recommended")}
    got["chain_steps"] = list(bo.model.chain_steps)
    # one more suggest, replayed, its draws given back to the generator
    state = bo.generator.get_state()
    t0 = time.time()
    bo.suggest()
    torch.cuda.synchronize()
    replayed = time.time() - t0
    bo.generator.set_state(state)
    return {"programs": by_kind, "suggest_replayed_seconds": replayed,
            "never_stages": never["stages"], "bitwise_equal_to_never": {
                k: bool(np.array_equal(np.asarray(got[k]),
                                       np.asarray(never[k]), equal_nan=True))
                for k in got}}


def _check_programs(path, line, kinds) -> None:
    """Each of ``kinds`` replayed on the path, and its results equal to
    CAPTURE = "never" (:func:`_programs_vs_never`'s ``line``)."""
    for kind in kinds:
        check(line["programs"].get(kind, {}).get("replays", 0) > 0,
              f"the {path} did not replay its {kind} program: "
              f"{line['programs']}")
    check(all(line["bitwise_equal_to_never"].values()),
          f"the {path} with programs and CAPTURE = 'never' differ: "
          f"{line['bitwise_equal_to_never']}")


def phase_cfkg(torch):
    """One cf-KG iteration through the driver at the main path's size:
    BraninFidelity (d = 3, the last coordinate a fidelity in [0.05, 1]),
    500 observations (512 after the bucket), 16 members, q = 4, 200
    multistarts, 128 MC draws, float32 (the settings of
    benchmarks/sample_efficiency_r04.py:117-121).  Every launch counter is
    set to 0 just before and read just after: kernel A's gate takes no
    fidelity dim, as the JAX package's does, so A may not launch, while B
    (the chain) and C (the fits) must.  Every stage runs as a program (the
    warm KG step too: the fidelity cost's backward reads nothing from the
    host), each replayed, and the iteration equals its CAPTURE = "never"
    twin bit for bit.  Returns the optimizer."""
    import numpy as np
    from cornell_moe_tpu_torch.bayes_opt import BayesianOptimizer
    from cornell_moe_tpu_torch.utils.synthetic_functions import \
        BraninFidelity

    def make_bo():
        return BayesianOptimizer(
            objective_func=BraninFidelity(), method="KG", num_to_sample=Q,
            n_hypers=N_HYPERS, noisy=True, standardize=True, device=DEVICE,
            dtype=torch.float32, verbose=False)

    bo = make_bo()
    check(bo.num_fidelity == 1 and bo.dim == 3 and
          bo.sgd_params.num_multistarts == MULTISTARTS and
          bo.num_mc == NUM_MC, "cf-KG size changed")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = snapshot()
    t0 = time.time()
    rec = bo.run(num_iterations=1, num_init_pts=NUM_OBS)[-1]
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = kernel_launches(before)
    peak = torch.cuda.max_memory_allocated()
    twin = _programs_vs_never(torch, bo, rec, make_bo)
    states = bo.model.models
    sugg, r = rec["suggested"], rec["recommended"]
    capital = float(np.max(np.prod(sugg[:, 2:], axis=1)))
    emit({"phase": "cfkg_path", "seconds": wall,
          "stages": {x["phase"]: x["seconds"] for x in bo.timer.records},
          "num_sampled": int(bo.model._data.num_sampled),
          "ensemble": int(states.chol_K.shape[0]),
          "padded_n": int(states.chol_K.shape[-1]), "dim": bo.dim,
          "num_fidelity": bo.num_fidelity,
          "chain_steps": bo.model.chain_steps,
          "members_replaced": bo.model.members_replaced,
          "voi": rec["voi"], "suggested": sugg.tolist(),
          "recommended": r.tolist(), "true_value": rec["true_value"],
          "capital": rec["capital"], "max_memory_allocated": peak,
          "launches": counts, **twin})
    _check_programs("cf-KG path", twin, PROGRAM_KINDS)
    check(counts.get("descent_run", 0) == 0 and
          counts.get("descent_run_fma", 0) == 0,
          "the cf-KG path launched kernel A")
    check(counts.get("lml_fused", 0) > 0 and
          counts.get("covariance_with_noise", 0) > 0,
          "the cf-KG path did not launch kernels B and C")
    check(bool(((sugg[:, 2] >= 0.05) & (sugg[:, 2] <= 1.0)).all()),
          f"suggested fidelities {sugg[:, 2]} outside [0.05, 1]")
    check(rec["capital"] == capital,
          f"capital {rec['capital']} is not the batch's largest fidelity "
          f"product {capital}")
    check(r[2] == 1.0, f"recommended fidelity {r[2]} is not 1")
    check(math.isfinite(rec["voi"]) and math.isfinite(rec["true_value"]),
          "cf-KG VOI or true value not finite")
    check(bool(torch.isfinite(states.chol_K).all()),
          "a cf-KG ensemble member's chol_K is non-finite")
    return bo


def _covariance_case(torch, x, h, nv, kernel_name):
    """Kernel C against its plain version on one input, by the rule of
    phase_equivalence: rtol 2e-4, atol 2e-5, and K equal to K^T bit for
    bit.  Returns (line fields, ok, the kernel's call, the plain version's
    call)."""
    from cornell_moe_tpu_torch.ops import kernels
    args = (x.contiguous(), h.contiguous(), nv.contiguous(), kernel_name)
    got = kernels.covariance_with_noise(*args)
    ref = kernels.covariance_with_noise_plain(*args)
    err = (got - ref).abs()
    symmetric = bool(torch.equal(got, got.transpose(-1, -2)))
    ok = bool((err <= 2e-5 + 2e-4 * ref.abs()).all()) and symmetric
    return {"kernel": "covariance_with_noise", "shape": list(got.shape),
            "max_abs_err": err.max().item(),
            "max_rel_err": (err / ref.abs().clamp_min(1e-30)).max().item(),
            "symmetric_bitwise": symmetric,
            "tolerance": "rtol 2e-4, atol 2e-5; K equal to K^T bit for bit",
            "ok": ok}, ok, (lambda: kernels.covariance_with_noise(*args)), \
        (lambda: kernels.covariance_with_noise_plain(*args))


def _covariance_line(torch, path, x, h, nv, kernel_name) -> None:
    """Kernel C against its plain version (:func:`_covariance_case`) on one
    of a path's own inputs, timed as the kernels' summary times the main
    path's (device and call time, 20 calls); prints one equivalence line
    and fails the script if they disagree."""
    from cmoe_bench import roofline
    fields, ok, call, plain = _covariance_case(torch, x, h, nv, kernel_name)
    emit({"phase": "equivalence", "path": path, "kernel_name": kernel_name,
          **fields, "times": _timed(torch, call, 20),
          "plain": _timed(torch, plain, 20), "timing": TIMING.format(20),
          "bound_ms": roofline.covariance_bound(
              h.shape[0], x.shape[0], x.shape[1], kernel_name)["ms"]})
    check(ok, f"covariance_with_noise disagrees at the {path} shape "
              f"{fields['shape']}")


def phase_cfkg_equivalence(torch, bo) -> None:
    """Kernels B and C against their plain versions at the cf-KG path's
    shapes (d = 3), by phase_equivalence's rules at d = 2: C on the path's
    ensemble (S 16, n 512); B (cluster instance, W = 8 and 16, Np 512) with
    walker lengths drawn as there, against the plain version at rtol 5e-4
    and the large-Np instance at rtol 1e-6.  Each is timed as the kernels'
    summary times the main path's (device and call time, 20 calls)."""
    from cmoe_bench import roofline
    from cornell_moe_tpu_torch.ops import kernels

    model = bo.model
    dev = model.device
    g = torch.Generator(device=dev).manual_seed(4321)
    states = model.models
    x, y, pn = model._padded_data()
    _covariance_line(torch, "cfkg_path", x, states.covariance.hyperparameters,
                     states.noise_variance + states.point_noise[..., 0],
                     model.kernel_name)

    w, d, np_ = model.n_hypers, model.dim, x.shape[0]
    f32 = dict(device=dev, dtype=torch.float32)
    width = (bo.domain.upper - bo.domain.lower).to(torch.float32)
    lengths = (0.3 + 0.4 * torch.rand((w, d), generator=g, **f32)) * width
    alphas = 0.8 + torch.rand((w,), generator=g, **f32)
    noises = 1e-2 + 1e-2 * torch.rand((w, 1), generator=g, **f32)
    for nw in (w // 2, w):
        check(kernels.lml_fused_instance(np_) == "cluster",
              f"Np={np_} does not take the cluster instance")
        largs = ((x.T[None] / lengths[:nw, :, None]).contiguous(),
                 alphas[:nw].contiguous(),
                 (noises[:nw] + pn[None, :, 0]).contiguous(),
                 y[None, :, 0].expand(nw, np_).contiguous(), np_,
                 model.kernel_name)
        quad, logdet = kernels.lml_fused(*largs)
        quad_g, logdet_g = kernels.lml_fused_global(*largs)
        quad_p, logdet_p = kernels.lml_fused_plain(*largs)

        def rel(a, b):
            return ((a.double() - b.double()).abs() /
                    b.double().abs().clamp_min(1.0)).max().item()

        errs = {"quad": rel(quad, quad_p), "logdet": rel(logdet, logdet_p),
                "kernel_vs_large_np_instance": max(rel(quad, quad_g),
                                                   rel(logdet, logdet_g))}
        ok = errs["quad"] < 5e-4 and errs["logdet"] < 5e-4 and \
            errs["kernel_vs_large_np_instance"] < 1e-6
        emit({"phase": "equivalence", "path": "cfkg_path",
              "kernel": "lml_fused", "instance": "cluster", "W": nw,
              "Np": np_, "d": d,
              "max_abs_err": max((quad - quad_p).abs().max().item(),
                                 (logdet - logdet_p).abs().max().item()),
              "max_rel_err": errs,
              "times": _timed(torch, lambda: kernels.lml_fused(*largs), 20),
              "plain": _timed(torch, lambda: kernels.lml_fused_plain(*largs),
                              20), "timing": TIMING.format(20),
              "bound_ms": roofline.lml_bound(nw, np_, d,
                                             model.kernel_name)["ms"],
              "tolerance": "rtol 5e-4 vs plain, rtol 1e-6 vs the large-Np "
                           "instance", "ok": ok})
        check(ok, f"lml_fused disagrees at the cf-KG path's W={nw}, d={d}")


LCB_MEAN_RTOL = 1e-3      # of max(1, max |mu64|), as phase_small_reference
LCB_VARIANCE_RTOL = 1e-4  # of the member's signal variance alpha


# The bfloat16 fantasy solve's bounds on the JAX package's test problems,
# each a fraction of the float32 ("never") output's scale, mu_u's absolute
# (tests/test_linalg.py:139-175, tests/test_knowledge_gradient.py:258-350),
# and the seeds of the CRN band
LOWP_BOUNDS = {"va": 3e-4, "w": 2e-2, "rhs_grad": 2e-2, "mu_u": 1e-4,
               "chol_u": 8e-3, "v": 2e-2}
LOWP_CRN_SEEDS = (100, 101, 102)


@contextlib.contextmanager
def _fantasy_switch(value: str):
    """``config.KG_FANTASY_LOWP`` set to ``value`` for the block, "never"
    (the default) after it."""
    from cornell_moe_tpu_torch import config
    config.KG_FANTASY_LOWP = value
    try:
        yield
    finally:
        config.KG_FANTASY_LOWP = "never"


def _fantasy_outputs(torch, states, unions, lowp: bool) -> dict:
    """va and w of the solve pair on the unions' kernel columns, and the
    batched fantasy model's var_u (chol_u chol_u^T less the noise), chol_u
    and v, with ``config.KG_FANTASY_LOWP`` "always" (``lowp``) or "never"
    (float64 states take the float64 path either way)."""
    from cornell_moe_tpu_torch import config
    from cornell_moe_tpu_torch.acquisition import knowledge_gradient as kg
    from cornell_moe_tpu_torch.models import gp as gp_mod
    from cornell_moe_tpu_torch.ops import linalg

    with _fantasy_switch("always" if lowp else "never"):
        k_xu = gp_mod._mix_cov(states, unions.reshape(-1, unions.shape[-1]),
                               ())
        va, w = linalg.fantasy_solves_rhs_grad_only(
            states.chol_K, states.inv_chol_K, k_xu,
            inv_chol_lowp=states.inv_chol_K.to(torch.bfloat16)
            if config.kg_fantasy_lowp_enabled(k_xu.dtype) else None)
        _, chol_u, v, noise_eff = kg._build_fantasy_model_batch(states,
                                                                unions)
    var_u = chol_u @ chol_u.transpose(-1, -2) - torch.diag_embed(noise_eff)
    return {"va": va, "w": w, "var_u": var_u, "chol_u": chol_u, "v": v}


def _err_over_scale(torch, got, ref) -> float:
    """max |got - ref| over max |ref|, where both are finite (None when no
    entry is)."""
    both = torch.isfinite(got) & torch.isfinite(ref)
    if not bool(both.any()):
        return None
    g, r = got.double()[both], ref.double()[both]
    return ((g - r).abs().max() / r.abs().max()).item()


def _lowp_test_problems(torch) -> dict:
    """The bfloat16 route against "never" on the card, in float32, on the
    JAX package's own test problems, where its bounds are stated: the SPD
    system of tests/test_linalg.py (K = A A^T + 40 I, 7 right-hand sides;
    va, w and the gradient of sum(sin va) + sum(cos w)), and the GP of
    tests/test_knowledge_gradient.py:258 (10 points in [-2, 2] from its
    seed-0 stream, Matern 2.5 (1.0, 0.8), noise 1e-3, 5 unions of 2
    points; values, then, on the stream's next 10 points, with the slope
    observed and sampled).  Returns each output's error: mu_u's absolute,
    the others over their scale."""
    import numpy as np
    from cornell_moe_tpu_torch import config
    from cornell_moe_tpu_torch.acquisition import knowledge_gradient as kg
    from cornell_moe_tpu_torch.models import mcmc as mcmc_mod
    from cornell_moe_tpu_torch.ops import linalg

    f32 = dict(device=DEVICE, dtype=torch.float32)
    rng = np.random.default_rng(0)
    a = rng.standard_normal((40, 40))
    chol = np.linalg.cholesky(a @ a.T + 40 * np.eye(40))
    sys_ = [torch.as_tensor(t, **f32) for t in
            (chol, np.linalg.inv(chol), rng.standard_normal((40, 7)))]

    def pair(lowp):
        c, inv, rhs = sys_
        r = rhs.clone().requires_grad_(True)
        va, w = linalg.fantasy_solves_rhs_grad_only(
            c, inv, r, inv_chol_lowp=inv.to(torch.bfloat16) if lowp
            else None)
        (torch.sum(torch.sin(va)) + torch.sum(torch.cos(w))).backward()
        return {"va": va.detach(), "w": w.detach(), "rhs_grad": r.grad}

    exact, lowp = pair(False), pair(True)
    out = {"linalg": {k: _err_over_scale(torch, lowp[k], exact[k])
                      for k in exact}}
    r = np.random.default_rng(0)
    for derivs in ((), (0,)):
        x = r.uniform(-2, 2, (10, 1))
        y = np.column_stack([np.sin(x[:, 0])] +
                            ([np.cos(x[:, 0])] if derivs else []))
        st = mcmc_mod.fit_gp_ensemble(
            "matern_2.5", torch.tensor([[1.0, 0.8]], **f32),
            torch.full((1, 1 + len(derivs)), 1e-3, **f32), x, y, derivs)
        unions = torch.as_tensor(np.random.default_rng(3).uniform(
            -2, 2, size=(5, 2, 1)), **f32)
        builds = []
        for value in ("never", "always"):
            with _fantasy_switch(value):
                builds.append(kg._build_fantasy_model_batch(st, unions,
                                                            derivs))
        (mu, chol_u, v, _), (mu_lp, chol_lp, v_lp, _) = builds
        out["kg_" + ("values" if not derivs else "d0")] = {
            "mu_u": (mu_lp - mu).abs().max().item(),
            "chol_u": _err_over_scale(torch, chol_lp, chol_u),
            "v": _err_over_scale(torch, v_lp, v)}
    return out


def _program_replays(cache, lowp: bool) -> dict:
    """Replays of the programs by kind for one setting of the switch
    (every program's key holds it, ``programs.keyed_switch``)."""
    value = ("config.KG_FANTASY_LOWP", "always" if lowp else "never")
    out = {}
    for key, prog in cache.programs().items():
        if value in key:
            out[key[0]] = out.get(key[0], 0) + prog.replays
    return out


def phase_fantasy_lowp(torch, bo) -> None:
    """The bfloat16 fantasy solve (``config.KG_FANTASY_LOWP`` "always") on
    the main path's fitted ensemble (16 members, Np 512, float32).

    (a) On the JAX package's test problems (:func:`_lowp_test_problems`)
    the route must hold the JAX tests' bounds (``LOWP_BOUNDS``).  On the
    unions of one suggest (its 200 Latin-hypercube start blocks of q = 4)
    the fantasy model under "always" against "never" and both against a
    float64 fit of the same hyperparameters: the largest error of va, w,
    var_u, chol_u and v over its scale, read against the same bounds and
    reported (the JAX package measured the route's error to grow with
    the ensemble's conditioning, and rejected it as a default for that).
    One bfloat16 product with float32 output (``linalg._bdot``) at these
    shapes on random operands must be within 1e-5 of the float64 sum of
    the same bfloat16 products (a bfloat16 output would be about 2e-3
    off); both builds timed.
    (b) From one generator state, the driver's suggest under "never" (the
    reference pick) and under "always" (it builds its programs again,
    every key holding the switch; a second call replays them), each
    pick's VOI under three more draws of normals (the CRN band), then the
    observation of the "always" pick under "always": wall times, builds,
    and the launches of A in the suggest and of B and C in the retrain.  (c) Back under "never", the
    next suggest builds nothing and replays the "never" programs, not the
    "always" ones."""
    import numpy as np
    from cornell_moe_tpu_torch import config
    from cornell_moe_tpu_torch.acquisition import knowledge_gradient as kg
    from cornell_moe_tpu_torch.acquisition.expected_improvement import (
        draw_antithetic_normals)
    from cornell_moe_tpu_torch.bayes_opt import (
        best_so_far_from_discretization, seed_kg_discretization)
    from cornell_moe_tpu_torch.models import mcmc as mcmc_mod
    from cornell_moe_tpu_torch.ops import linalg, programs
    from cornell_moe_tpu_torch.ops.domains import RepeatedDomain

    check(config.KG_FANTASY_LOWP == "never", "the switch is not 'never'")
    model, dev = bo.model, bo.device
    states = model.models
    g = torch.Generator(device=dev).manual_seed(4321)
    unions = RepeatedDomain(domain=bo.domain, num_repeats=Q
                            ).generate_latin_hypercube_points(g, MULTISTARTS)
    f64 = mcmc_mod.fit_gp_ensemble(
        model.kernel_name, torch.as_tensor(model._hypers, device=dev,
                                           dtype=torch.float64),
        torch.as_tensor(model._noises, device=dev, dtype=torch.float64),
        model._data.points_sampled, model._scaled_values(),
        model.derivatives, bucket=model.bucket)
    never = _fantasy_outputs(torch, states, unions, False)
    always = _fantasy_outputs(torch, states, unions, True)
    exact = _fantasy_outputs(torch, f64, unions.double(), False)
    errors = {name: {"always_vs_never": _err_over_scale(
                         torch, always[name], never[name]),
                     "always_vs_float64": _err_over_scale(
                         torch, always[name], exact[name]),
                     "never_vs_float64": _err_over_scale(
                         torch, never[name], exact[name])}
              for name in never}
    nonfinite = {k: {"never": int((~torch.isfinite(never[k])).sum()),
                     "always": int((~torch.isfinite(always[k])).sum())}
                 for k in ("chol_u", "v")}
    small = _lowp_test_problems(torch)
    ga = torch.Generator(device=dev).manual_seed(99)
    ra = torch.randn(states.inv_chol_K.shape, generator=ga,
                     device=dev).to(torch.bfloat16)
    rb = torch.randn(never["va"].shape, generator=ga, device=dev)
    prod_r = linalg._bdot(ra, rb)
    bdot_err = _err_over_scale(
        torch, prod_r, ra.double() @ rb.to(torch.bfloat16).double())

    def build(value):
        def fn():
            with _fantasy_switch(value):
                kg._build_fantasy_model_batch(states, unions)
        return fn

    build_times = {v: _timed(torch, build(v), 10)
                   for v in ("never", "always")}

    # (b) the driver's suggest under each setting, from one generator state
    gen = bo.generator
    state0 = gen.get_state()
    runs = {}
    for label in ("never", "always", "always_replayed"):
        gen.set_state(state0)
        with _fantasy_switch("never" if label == "never" else "always"):
            torch.cuda.synchronize()
            before = snapshot()
            b0, t0 = programs.build_count(), time.time()
            pts, voi = bo.suggest()
            torch.cuda.synchronize()
        runs[label] = {"seconds": time.time() - t0,
                       "builds": programs.build_count() - b0,
                       "suggested": pts.tolist(), "voi": voi,
                       "launches": kernel_launches(before)}
    gen.set_state(state0)
    discrete = seed_kg_discretization(
        gen, states, bo.domain, qei_params=bo.sgd_params,
        ps_params=bo.inner_sgd_params, conv_tol=bo.seed_conv_tol,
        chunk_size=bo.suggest_chunk_size, program_cache=bo.program_cache)
    best = best_so_far_from_discretization(states, discrete)
    crn = {}
    for label in ("never", "always"):
        pts = torch.as_tensor(runs[label]["suggested"], device=dev,
                              dtype=bo.dtype)
        crn[label] = [float(kg.score_knowledge_gradient_mcmc(
            states, pts, discrete, draw_antithetic_normals(
                torch.Generator(device=dev).manual_seed(seed), NUM_MC, Q,
                device=dev, dtype=bo.dtype),
            kg.inner_domain(bo.domain, 0), bo.inner_sgd_params, best,
            program_cache=bo.program_cache)) * model.value_scale
            for seed in LOWP_CRN_SEEDS]
    band = max(abs(v - runs["never"]["voi"]) for v in crn["never"])
    gen.set_state(state0)
    with _fantasy_switch("always"):
        torch.cuda.synchronize()
        before = snapshot()
        t0 = time.time()
        bo.observe(np.asarray(runs["always"]["suggested"]))
        torch.cuda.synchronize()
    observe = {"seconds": time.time() - t0,
               "launches": kernel_launches(before),
               "chain_steps": model.last_chain_steps}

    # (c) back under "never": the "never" programs replay
    before = {on: _program_replays(bo.program_cache, on)
              for on in (False, True)}
    b0, t0 = programs.build_count(), time.time()
    pts_c, voi_c = bo.suggest()
    torch.cuda.synchronize()
    back = {"seconds": time.time() - t0, "voi": voi_c,
            "builds": programs.build_count() - b0,
            "replays_never": _program_replays(bo.program_cache, False),
            "replays_always": _program_replays(bo.program_cache, True),
            "replays_before": {"never": before[False],
                               "always": before[True]}}

    line = {"phase": "fantasy_lowp", "unions": list(unions.shape),
            "ensemble": int(states.chol_K.shape[0]),
            "padded_n": int(states.chol_K.shape[-1]),
            "jax_test_problems": small, "bounds": LOWP_BOUNDS,
            "errors_over_scale": errors,
            "within_bounds": {k: errors[k]["always_vs_never"] is not None and
                              errors[k]["always_vs_never"] <= LOWP_BOUNDS[k]
                              for k in ("va", "w", "chol_u", "v")},
            "nonfinite": nonfinite, "bdot_random_vs_float64": bdot_err,
            "bdot_dtype": str(prod_r.dtype), "build_times": build_times,
            "suggest": runs, "crn_seeds": list(LOWP_CRN_SEEDS),
            "voi_under_crn_seeds": crn, "crn_band": band,
            "voi_always_minus_never_over_band":
                (runs["always"]["voi"] - runs["never"]["voi"]) / band
                if band > 0 else None,
            "observe_always": observe, "back_to_never": back,
            "timing": TIMING.format(10)}
    emit(line)
    for problem, errs in small.items():
        for name, err in errs.items():
            check(err is not None and err <= LOWP_BOUNDS[name],
                  f"the bf16 fantasy solve's {name} on the JAX test problem "
                  f"{problem} is {err} from float32's, above "
                  f"{LOWP_BOUNDS[name]}")
    check(prod_r.dtype == torch.float32 and bdot_err is not None and
          bdot_err <= 1e-5, f"the bf16 product with float32 output is "
          f"{bdot_err} of its scale from the float64 sum")
    check(errors["va"]["always_vs_never"] is not None and
          errors["va"]["always_vs_never"] > 0, "the 'always' build did not "
          "take the bf16 route")
    a = runs["always"]
    check(math.isfinite(a["voi"]) and np.isfinite(a["suggested"]).all(),
          "the 'always' suggest is not finite")
    check(a["launches"].get("descent_run", 0) > 0, "the 'always' suggest "
          "did not launch kernel A")
    check(observe["launches"].get("lml_fused", 0) > 0 and
          observe["launches"].get("covariance_with_noise", 0) > 0,
          "the retrain under 'always' did not launch kernels B and C")
    check(a["builds"] > 0 and runs["always_replayed"]["builds"] == 0 and
          runs["always_replayed"]["suggested"] == a["suggested"],
          "the 'always' suggest did not build its programs once and "
          "replay them")
    check(back["builds"] == 0 and back["replays_always"] ==
          back["replays_before"]["always"] and all(
              back["replays_never"][k] > back["replays_before"]["never"][k]
              for k in ("kg_cold", "kg_warm_step")),
          f"back under 'never' the suggest did not replay the 'never' "
          f"programs: {back}")


SWITCH_KEY_BLOCKS = 8     # start blocks of A's cold step in switch_keys


def _switch_runs(torch, cache, module, name, kind, kernel, run) -> tuple:
    """``run()`` (a stage whose program is of ``kind``) under ``name`` of
    ``module`` "auto", then "never", then "auto" again, on the same
    inputs; the launches of each run read from just before it.  The switch
    is "auto" afterwards.  Returns (per run: wall
    seconds, builds, ``kernel``'s launches, the programs of ``kind`` and
    their replays per switch value; per run: the result)."""
    from cornell_moe_tpu_torch.ops import programs
    qual = f"{module.__name__.rsplit('.', 1)[-1]}.{name}"
    line, results = {}, {}
    for label, value in (("auto", "auto"), ("never", "never"),
                         ("auto_again", "auto")):
        setattr(module, name, value)
        try:
            torch.cuda.synchronize()
            before = snapshot()
            b0, t0 = programs.build_count(), time.time()
            results[label] = run()
            torch.cuda.synchronize()
        finally:
            setattr(module, name, "auto")
        progs = {v: [p.replays for k, p in cache.programs().items()
                     if programs.kind(k) == kind and (qual, v) in k]
                 for v in ("auto", "never")}
        line[label] = {"seconds": time.time() - t0,
                       "builds": programs.build_count() - b0,
                       "launches": kernel_launches(before).get(kernel, 0),
                       "programs": {v: len(r) for v, r in progs.items()},
                       "replays": {v: sum(r) for v, r in progs.items()}}
    return line, results


def _check_switch(label, line, same) -> None:
    """The switch_keys rule for one kernel: "never" builds one program of
    its kind and launches the kernel 0 times; back under "auto" nothing is
    built, the "auto" program replays, the kernel launches as in the first
    run, and the result is the first run's bit for bit (``same``)."""
    a, n, b = line["auto"], line["never"], line["auto_again"]
    check(n["builds"] == 1 and n["launches"] == 0 and
          n["programs"]["never"] == a["programs"]["never"] + 1,
          f"{label} under 'never' did not build one program and launch "
          f"nothing: {line}")
    check(a["launches"] > 0 and b["builds"] == 0 and
          b["launches"] == a["launches"] and
          b["programs"] == n["programs"] and
          b["replays"]["auto"] > n["replays"]["auto"] and
          b["replays"]["never"] == n["replays"]["never"],
          f"{label} back under 'auto' did not replay its first program: "
          f"{line}")
    check(same, f"{label} back under 'auto' differs from its first run")


def _bitwise(torch, a, b) -> bool:
    return all(x is None and y is None or torch.equal(x, y)
               for x, y in zip(a, b))


def phase_switch_keys(torch, bo) -> None:
    """Each kernel switch is part of every program's key
    (``programs.keyed_switch``), so flipping it between two calls of one
    driver builds the stage again instead of replaying the graph captured
    under the other value.  On the main path's driver after its iteration,
    for each kernel, its stage under "auto", under "never" and under
    "auto" again (:func:`_switch_runs`, :func:`_check_switch`), and the
    "never" result held to the "auto" one by the kernel's rule of
    phase_equivalence:

    - B (``mcmc.LML_PALLAS``): one 64-step segment of the retrain's chain
      (its ``chain_64`` program) from the model's walkers, every stretch
      z = 1 (each proposal its own walker, to rounding) and every finite
      proposal taken (u_accept = 0), so that both routes stay at the same
      walkers; the log posteriors at the end within rel 5e-3 of each
      other where both are finite, the kernel's finite wherever float64
      is (their deviations from float64 reported: at converged walkers
      float32 is about 1e-2 off either way).
    - C (``covariance.USE_PALLAS``): the ensemble fit at the model's
      hyperparameters (its ``fit`` program); L L^T of both fits, in
      float64, within C's rtol 2e-4, atol 2e-5 of each other, over the
      members whose float32 factor is finite in both.
    - A (``knowledge_gradient.DESCENT_PALLAS``): the KG multistart's cold
      step (its ``kg_cold`` program) at ``SWITCH_KEY_BLOCKS`` start blocks
      of the main path's q, draws and inner parameters; the carried
      descent endpoints against the same step in float64 on the same
      state, per quantile in domain-width units: the kernel's within
      max(5e-5, 1.5 x the plain float32 route's)."""
    from cornell_moe_tpu_torch.acquisition import knowledge_gradient as kg
    from cornell_moe_tpu_torch.acquisition.expected_improvement import (
        draw_antithetic_normals)
    from cornell_moe_tpu_torch.bayes_opt import (
        best_so_far_from_discretization)
    from cornell_moe_tpu_torch.models import covariance as cov_mod
    from cornell_moe_tpu_torch.models import gp as gp_mod
    from cornell_moe_tpu_torch.models import mcmc as mcmc_mod
    from cornell_moe_tpu_torch.ops.domains import RepeatedDomain

    model, cache, dev = bo.model, bo.program_cache, bo.device
    states = model.models
    x, y, pn = model._padded_data()
    g = torch.Generator(device=dev).manual_seed(77)
    out = {}

    # B: the retrain's chain segment
    w, steps = model.n_hypers, mcmc_mod.CHAIN_GATE_SEGMENT
    half = (steps, 2, w // 2)
    u = torch.full(half, math.sqrt(2.0) - 1.0, device=dev, dtype=bo.dtype)
    idx = torch.randint(0, w // 2, half, generator=g, device=dev)
    acc = torch.zeros(half, device=dev, dtype=bo.dtype)
    pos0 = model.p0
    lp0 = model.log_posterior(pos0, x, y, pn)
    segment = model._segment_program(x, y, pn)
    line, res = _switch_runs(torch, cache, mcmc_mod, "LML_PALLAS",
                             "chain_64", "lml_fused",
                             lambda: segment(pos0, lp0, u, idx, acc))
    (pa, la, _), (pv, lv, _) = res["auto"], res["never"]
    data64 = [None if t is None else t.double() for t in (x, y, pn)]
    lp64 = model.log_posterior(pa.double(), *data64, force_plain=True)
    fin = torch.isfinite(lp64)
    both = torch.isfinite(la) & torch.isfinite(lv)
    rel = ((lv.double() - la.double()).abs() /
           la.double().abs().clamp_min(1.0))[both]
    ok_b = bool(both.any()) and bool(torch.isfinite(la)[fin].all()) and \
        rel.max().item() <= 5e-3
    line.update({
        "stage": "chain_64 segment of the retrain (z = 1, u_accept = 0)",
        "max_position_diff": (pa - pv).abs().max().item(),
        "finite": {"auto": int(torch.isfinite(la).sum()),
                   "never": int(torch.isfinite(lv).sum()),
                   "float64": int(fin.sum())},
        "max_rel_dev_never_vs_auto": rel.max().item()
        if bool(both.any()) else None,
        "max_rel_dev_vs_f64": {
            k: _finite_or_none(((v.double() - lp64).abs() /
                                lp64.abs().clamp_min(1.0))[fin & both])
            for k, v in (("auto", la), ("never", lv))},
        "tolerance": "never vs auto: max rel 5e-3 where both are finite; "
                     "auto finite wherever float64 is", "ok": ok_b})
    out["lml_fused"] = line
    _check_switch("B (LML_PALLAS)", line,
                  _bitwise(torch, res["auto"], res["auto_again"]))
    check(ok_b, f"the chain segment's log posteriors under 'never' are "
                f"off the 'auto' ones: {line}")

    # C: the ensemble fit
    def fit():
        st = model._fit(model._hypers, model._noises)
        return st.chol_K, st.K_inv_y, st.inv_chol_K

    line, res = _switch_runs(torch, cache, cov_mod, "USE_PALLAS", "fit",
                             "covariance_with_noise", fit)
    finite = [torch.isfinite(r[0]).flatten(1).all(dim=1)
              for r in (res["auto"], res["never"])]
    members = finite[0] & finite[1]
    ka, kv = (r[0][members].double() @ r[0][members].double().transpose(
        -1, -2) for r in (res["auto"], res["never"]))
    err = (ka - kv).abs()
    ok_c = bool(members.any()) and bool((err <= 2e-5 + 2e-4 * kv.abs()).all())
    line.update({"stage": "ensemble fit at the model's hyperparameters",
                 "shape": list(res["auto"][0].shape),
                 "finite_members": {"auto": int(finite[0].sum()),
                                    "never": int(finite[1].sum())},
                 "max_abs_err_llt": err.max().item(),
                 "max_rel_err_llt": (err / kv.abs().clamp_min(1e-30)
                                     ).max().item(),
                 "tolerance": "L L^T (float64) of both fits: rtol 2e-4, "
                              "atol 2e-5", "ok": ok_c})
    out["covariance_with_noise"] = line
    _check_switch("C (USE_PALLAS)", line,
                  _bitwise(torch, res["auto"], res["auto_again"]))
    check(ok_c, f"the fit under 'never' is off the 'auto' fit: {line}")

    # A: the KG multistart's cold step
    dom = bo.domain
    starts = RepeatedDomain(domain=dom, num_repeats=Q
                            ).generate_latin_hypercube_points(
                                g, SWITCH_KEY_BLOCKS)
    discrete = dom.generate_uniform_random_points_in_domain(
        g, states.chol_K.shape[0] * 11).reshape(-1, 11, dom.dim)
    normals = draw_antithetic_normals(g, NUM_MC, Q, device=dev,
                                      dtype=bo.dtype)
    best = best_so_far_from_discretization(states, discrete)
    cold, _ = kg._kg_step_programs(
        cache, states, dom, Q, None, discrete, normals, bo.inner_sgd_params,
        bo.inner_sgd_params, best, (), 0, bo.sgd_params)
    line, res = _switch_runs(torch, cache, kg, "DESCENT_PALLAS", "kg_cold",
                             "descent_run", lambda: cold(starts))
    tensors, layout = gp_mod.state_tensors(states)
    s64 = gp_mod.state_from_tensors(layout, [t.double() for t in tensors])
    inner64 = kg.inner_domain(type(dom)(bounds=dom.bounds.double()), 0)
    _, _, x64 = kg.knowledge_gradient_mcmc_batch_vg_carry(
        s64, starts.double(), discrete.double(), normals.double(), inner64,
        bo.inner_sgd_params, best.double(), num_to_sample=Q)
    width = (dom.upper - dom.lower).double()
    q = {k: _quantiles(torch, (res[k][2].double() - x64).abs() / width)
         for k in ("auto", "never")}
    ok_a = all(q["auto"][k] <= max(5e-5, 1.5 * q["never"][k])
               for k in q["auto"])
    line.update({"stage": f"kg_cold at {SWITCH_KEY_BLOCKS} start blocks",
                 "endpoints": list(x64.shape),
                 "endpoints_vs_f64": q,
                 "kg_max_abs_err": (res["auto"][0] - res["never"][0]
                                    ).abs().max().item(),
                 "tolerance": "per quantile, auto vs f64 <= max(5e-5, 1.5 "
                              "x never vs f64), domain-width units",
                 "ok": ok_a})
    out["descent_run"] = line
    _check_switch("A (DESCENT_PALLAS)", line,
                  _bitwise(torch, res["auto"], res["auto_again"]))
    check(ok_a, f"the KG cold step under 'auto' is off the float64 "
                f"endpoints: {line}")
    emit({"phase": "switch_keys", **out})


def phase_lcb(torch, states) -> None:
    """LCB batch selection (``lower_confidence_bound_optimization``) on
    member 0 of the main path's ensemble over 10,000 uniform candidates in
    Branin's domain, q = 4, float32 on the card, held to the same member
    refitted in float64 on the card.  Checks q picks and one launch of
    kernel C per fantasy append; every pick in the plausible set (LCB <=
    min(mu + sigma)) of the float64 posterior; the posterior mean at every
    candidate within LCB_MEAN_RTOL max(1, max |mu64|) of float64's and the
    posterior variance within LCB_VARIANCE_RTOL alpha (float32's alpha -
    |L^-1 k|^2 cancels, PERF.md); every pick's standard deviation finite.
    The float32 plausible set and the distinct picks are printed: the
    reference's rule may repeat a pick (ROADMAP Queue 3).  Then C against
    its plain version on the first fantasy append's input (n = 1)."""
    from cornell_moe_tpu_torch.acquisition import lower_confidence_bound as lcb
    from cornell_moe_tpu_torch.models import gp as gp_mod

    member = states.member(0)
    dom = kg_domain(member.points_sampled.device, torch.float32)
    cand = dom.generate_uniform_random_points_in_domain(
        torch.Generator(device=dom.bounds.device).manual_seed(99),
        LCB_CANDIDATES)
    torch.cuda.synchronize()
    before = snapshot()
    t0 = time.time()
    picks, _ = lcb.lower_confidence_bound_optimization(member, cand, Q)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = kernel_launches(before)

    def plain(v):
        return None if v is None else v.double()

    member64 = gp_mod.fit_gp(
        type(member.covariance)(hyperparameters=plain(
            member.covariance.hyperparameters)),
        plain(member.noise_variance), plain(member.points_sampled),
        plain(member.points_sampled_value), mean=plain(member.mean),
        point_noise=plain(member.point_noise))
    cand64 = cand.double()
    picks64, _ = lcb.lower_confidence_bound_optimization(member64, cand64, Q)
    mu = gp_mod.posterior_mean(member, cand)[:, 0].double()
    sd = lcb.posterior_stddev(member, cand).double()
    mu64 = gp_mod.posterior_mean(member64, cand64)[:, 0]
    sd64 = lcb.posterior_stddev(member64, cand64)
    plausible = (mu - sd) <= torch.min(mu + sd)
    plausible64 = (mu64 - sd64) <= torch.min(mu64 + sd64)
    at = [(cand == p).all(dim=1) for p in picks]
    in_set64 = [bool(plausible64[i].any()) for i in at]
    alpha = float(member64.covariance.hyperparameters[0])
    errs = {"posterior_mean_abs": (mu - mu64).abs().max().item(),
            "posterior_mean_limit": LCB_MEAN_RTOL * max(
                1.0, mu64.abs().max().item()),
            "posterior_variance_abs": (sd ** 2 - sd64 ** 2).abs().max().item(),
            "posterior_variance_limit": LCB_VARIANCE_RTOL * alpha}
    sd_picks = lcb.posterior_stddev(member, picks)
    lcb64 = mu64 - sd64
    emit({"phase": "lcb", "seconds": wall, "candidates": LCB_CANDIDATES,
          "q": Q, "picks": picks.tolist(),
          "distinct_picks": len({tuple(p) for p in picks.tolist()}),
          "plausible_set_size": int(plausible.sum()),
          "posterior_sd_at_picks": sd_picks.tolist(),
          "candidates_with_sd_0": int((sd == 0).sum()),
          "float64": {
              "picks": picks64.tolist(),
              "distinct_picks": len({tuple(p) for p in picks64.tolist()}),
              "plausible_set_size": int(plausible64.sum()),
              "candidates_with_sd_0": int((sd64 == 0).sum())},
          "picks_in_float64_plausible_set": in_set64,
          "first_pick_as_float64": bool(torch.equal(picks[0].double(),
                                                    picks64[0])),
          "float64_lcb_above_its_minimum_at_first_pick":
              (lcb64[at[0]].min() - lcb64.min()).item(),
          **errs, "alpha": alpha,
          "tolerance": "every pick in the float64 plausible set; |mu - mu64| "
                       f"<= {LCB_MEAN_RTOL} max(1, max |mu64|); |sd^2 - "
                       f"sd64^2| <= {LCB_VARIANCE_RTOL} alpha",
          "launches": counts})
    check(tuple(picks.shape) == (Q, 2), "LCB did not return q picks")
    check(counts.get("covariance_with_noise", 0) == Q - 1,
          "LCB's fantasy appends did not each launch kernel C")
    check(all(in_set64),
          "an LCB pick lies outside the float64 posterior's plausible set")
    check(errs["posterior_mean_abs"] <= errs["posterior_mean_limit"],
          "LCB's float32 posterior mean disagrees with float64's")
    check(errs["posterior_variance_abs"] <= errs["posterior_variance_limit"],
          "LCB's float32 posterior variance disagrees with float64's")
    check(bool(torch.isfinite(sd_picks).all()),
          "an LCB pick's posterior standard deviation is not finite")
    _covariance_line(torch, "lcb", picks[:1],
                     member.covariance.hyperparameters.reshape(1, -1),
                     member.noise_variance.reshape(1, 1),
                     member.covariance.name)


PES_ITERATIONS = 2


def _pes_run(torch, capture: str) -> dict:
    """PES_ITERATIONS iterations of ``pes_driver.run_PES`` from seed 0 with
    ``programs.CAPTURE`` = ``capture``: the history, the artifacts, the
    timer's parts, and per iteration C's launches, the memory allocated
    at its start and its peak (read between iterations by a wrapper of
    ``sample_hypers``, the first thing an iteration does after releasing
    its programs)."""
    import tempfile

    import numpy as np
    from cornell_moe_tpu_torch.acquisition import pes_driver
    from cornell_moe_tpu_torch.ops import programs
    from cornell_moe_tpu_torch.utils.logging_utils import PhaseTimer
    from cornell_moe_tpu_torch.utils.synthetic_functions import Hartmann6

    f = Hartmann6()
    timer = PhaseTimer()
    marks = []
    sample_hypers = pes_driver.sample_hypers

    def mark():
        torch.cuda.synchronize()
        marks.append({"launches_c": kernel_launches(before).get(
                          "covariance_with_noise", 0),
                      "allocated": torch.cuda.memory_allocated(),
                      "peak": torch.cuda.max_memory_allocated()})
        torch.cuda.reset_peak_memory_stats()

    def marked(*args, **kw):
        mark()
        return sample_hypers(*args, **kw)

    programs.CAPTURE = capture
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = snapshot()
    pes_driver.sample_hypers = marked
    try:
        with tempfile.TemporaryDirectory() as out_dir:
            t0 = time.time()
            hist = pes_driver.run_PES(
                lambda p: float(f.evaluate_true(p)[0]), [0.0] * 6,
                [1.0] * 6, 6, number_of_hyperparameter_sets=PES_SETS,
                number_of_burnin=PES_BURNIN,
                number_of_initial_points=PES_INIT,
                number_of_iterations=PES_ITERATIONS, gridsize=PES_GRID,
                seed=0, output_dir=out_dir, verbose=False, device=DEVICE,
                dtype=torch.float32, timer=timer)
            mark()
            wall = time.time() - t0
            art = {name: np.loadtxt(os.path.join(out_dir, name), ndmin=2)
                   for name in ("Xsamples.txt", "Ysamples.txt",
                                "guesses.txt")}
    finally:
        pes_driver.sample_hypers = sample_hypers
        programs.CAPTURE = "auto"
    per_part = len(timer.records) // PES_ITERATIONS
    iterations = []
    for i, h in enumerate(hist):
        recs = timer.records[i * per_part:(i + 1) * per_part]
        iterations.append({
            "parts": {r["phase"]: r["seconds"] for r in recs},
            "finite_sets": [r["finite_sets"] for r in recs
                            if r["phase"] == "x_star_draws_and_ep"][0],
            "programs": h["programs"],
            "capture_seconds": h["capture_seconds"],
            "allocated_at_start": marks[i]["allocated"],
            "max_memory_allocated": marks[i + 1]["peak"],
            "launches_c": marks[i + 1]["launches_c"] -
            marks[i]["launches_c"]})
    return {"seconds": wall, "history": hist, "artifacts": art,
            "iterations": iterations,
            "allocated_after_run": marks[-1]["allocated"]}


def phase_pes(torch) -> None:
    """PES_ITERATIONS iterations of ``pes_driver.run_PES`` on Hartmann6 at
    the reference scale of benchmarks/bench_suite.py:246-336: 60 initial
    points, M = 100 hyperparameter sets, burn-in 50, 1000 random features,
    grid 500, float32 on the card, artifacts in a temporary directory,
    first with programs (the chain's segments, the x* polish step, EP's
    sweep, the two grids and the two polish steps, captured anew in each
    iteration after the release of the last one's), then from the same
    seed with ``CAPTURE = "never"``: history and artifacts equal bit for
    bit.  Per iteration the parts (the driver's PhaseTimer), builds and
    replays by kind, capture seconds, peak memory and C's launches (the
    port's gate has no size window, so the M-set SE fits at n = 60 and 61
    in the first iteration, 61 and 62 in the second, launch it).  Then C
    against its plain version on the first iteration's fits' own inputs:
    the artifacts' first 60 and 61 points, and the sets the driver's
    ``sample_hypers`` draws there from the run's seed (the run's draws
    replayed: its initial design, then the chain)."""
    import numpy as np
    from cornell_moe_tpu_torch.acquisition import pes_driver
    from cornell_moe_tpu_torch.models.covariance import SquareExponential
    from cornell_moe_tpu_torch.ops.domains import TensorProductDomain

    got = _pes_run(torch, "auto")
    never = _pes_run(torch, "never")
    hist, art = got["history"], got["artifacts"]
    rows = {name: a.shape[0] for name, a in art.items()}
    bitwise = {k: all(np.array_equal(np.asarray(a[k]), np.asarray(b[k]))
                      for a, b in zip(hist, never["history"]))
               for k in ("suggested", "value", "recommended", "best_so_far")}
    bitwise["artifacts"] = all(np.array_equal(art[k], never["artifacts"][k])
                               for k in art)
    h = hist[-1]
    its = got["iterations"]
    emit({"phase": "pes_path", "seconds": got["seconds"],
          "parts": its[0]["parts"], "initial_points": PES_INIT,
          "sets": PES_SETS, "finite_sets": its[0]["finite_sets"],
          "iterations": its, "suggested": h["suggested"].tolist(),
          "value": h["value"], "recommended": h["recommended"].tolist(),
          "best_so_far": h["best_so_far"], "artifact_rows": rows,
          "max_memory_allocated": max(i["max_memory_allocated"]
                                      for i in its),
          "launches": {"covariance_with_noise": sum(i["launches_c"]
                                                   for i in its)},
          "allocated_after_run": got["allocated_after_run"],
          "never": {"seconds": never["seconds"],
                    "iterations": [{k: i[k] for k in (
                        "parts", "max_memory_allocated", "launches_c")}
                        for i in never["iterations"]]},
          "bitwise_equal_to_never": bitwise})
    kinds = set(its[0]["programs"])
    check(all(i["finite_sets"] >= 1 for i in its),
          "no PES hyperparameter set came out finite")
    check(all(i["launches_c"] == 2 for i in its + never["iterations"]),
          "the PES path's fits did not launch kernel C twice per iteration")
    check(all(bitwise.values()),
          f"PES with programs and CAPTURE = 'never' differ: {bitwise}")
    check(len(kinds) >= 7 and all(
        set(i["programs"]) == kinds and
        all(v["builds"] == 1 for v in i["programs"].values())
        for i in its), f"PES programs by iteration: "
                       f"{[i['programs'] for i in its]}")
    # the released programs leave nothing behind: iteration 2's peak
    # exceeds iteration 1's (one more observation) by no more than the
    # eager run's does, and the run ends holding no more than iteration 2
    # started with, each within 8 MiB (a quarter of one cuBLAS workspace)
    peaks = [i["max_memory_allocated"] for i in its]
    eager_peaks = [i["max_memory_allocated"] for i in never["iterations"]]
    check(peaks[1] - peaks[0] <= eager_peaks[1] - eager_peaks[0] + 2**23 and
          got["allocated_after_run"] <= its[1]["allocated_at_start"] + 2**23,
          f"PES memory grew from iteration 1 to 2: peaks {peaks} (eager: "
          f"{eager_peaks}), {its[1]['allocated_at_start']} allocated at "
          f"iteration 2's start, {got['allocated_after_run']} after the run")
    for h in hist:
        for name in ("suggested", "recommended"):
            v = np.asarray(h[name])
            check(bool(np.isfinite(v).all() and (v >= 0.0).all() and
                       (v <= 1.0).all()),
                  f"PES {name} point {v} not finite in [0, 1]^6")
    n_rows = PES_INIT + PES_ITERATIONS
    check(rows == {"Xsamples.txt": n_rows, "Ysamples.txt": n_rows,
                   "guesses.txt": n_rows},
          f"PES artifacts have {rows} rows")

    f32 = dict(device=DEVICE, dtype=torch.float32)
    g = torch.Generator(device=DEVICE).manual_seed(0)
    design = TensorProductDomain.from_bounds(
        np.array([[0.0, 1.0]] * 6), **f32).generate_latin_hypercube_points(
            g, PES_INIT)
    xs = torch.as_tensor(art["Xsamples.txt"], **f32)
    ys = torch.as_tensor(art["Ysamples.txt"][:, 0], **f32)
    noise, lengths, sigma = pes_driver.sample_hypers(
        g, xs[:PES_INIT], ys[:PES_INIT], PES_SETS, PES_BURNIN)
    emit({"phase": "pes_fit_inputs", "replayed_design_as_artifact": bool(
        torch.equal(design, xs[:PES_INIT])), "sets": int(sigma.shape[0])})
    hypers = torch.cat([sigma[:, None], lengths], dim=1)
    for n in (PES_INIT, PES_INIT + 1):
        _covariance_line(torch, "pes_path", xs[:n], hypers,
                         noise[:, None].expand(PES_SETS, n),
                         SquareExponential.name)


def phase_small_reference(torch) -> None:
    """The card's float32 path (all three kernels) against the port's own
    float64 CPU path on a small input: ensemble fit, log-posterior and
    batched q-KG values.  Then the same on a small derivative-channel
    problem (12 points, d = 2, ds = (0, 1), no kernel on its path): the
    ensemble fit, its posterior mean and variance over the three channels
    and one batch of d-KG values."""
    import numpy as np
    from cornell_moe_tpu_torch.acquisition import knowledge_gradient as kg
    from cornell_moe_tpu_torch.bayes_opt import DEFAULT_SGD_PARAMS_PS
    from cornell_moe_tpu_torch.models import mcmc
    from cornell_moe_tpu_torch.ops.domains import TensorProductDomain

    rng = np.random.default_rng(7)
    n, s, b, m = 40, 4, 3, 16
    x = rng.random((n, 2))
    y = np.sin(3 * x[:, 0]) + x[:, 1]
    y = (y - y.mean()) / y.std()
    hypers = np.stack([0.5 + rng.random(s), 0.2 + 0.4 * rng.random(s),
                       0.2 + 0.4 * rng.random(s)], axis=1)
    noises = np.full((s, 1), 1e-2)
    unions = rng.random((b, Q, 2))
    normals = rng.standard_normal((m, Q))
    discrete = rng.random((s, 11, 2))
    thetas = np.log(np.concatenate([hypers, noises], axis=1))
    out = {}
    for dev, dt in ((DEVICE, torch.float32), ("cpu", torch.float64)):
        def t(a):
            return torch.as_tensor(a, device=dev, dtype=dt)
        states = mcmc.fit_gp_ensemble("matern_2.5", t(hypers), t(noises),
                                      x, y[:, None], bucket=16)
        dom = TensorProductDomain.from_bounds([[0.0, 1.0]] * 2, device=dev,
                                              dtype=dt)
        kg_best = torch.full((s,), float(y.min()), device=dev,
                                    dtype=dt)
        vals = kg.knowledge_gradient_batch(
            states, t(unions), t(discrete), t(normals), dom,
            DEFAULT_SGD_PARAMS_PS, kg_best)
        from cornell_moe_tpu_torch.utils.data_containers import \
            HistoricalData
        data = HistoricalData(2)
        data.append_historical_data(x, y)
        model = mcmc.GaussianProcessLogLikelihoodMCMC(
            data, bucket=16, device=dev, dtype=dt,
            generator=torch.Generator(device=dev).manual_seed(0))
        xp, yp, pn = model._padded_data()
        lp = model.log_posterior(t(thetas), xp, yp, pn)
        mu = kg.gp_mod.posterior_mean(states, t(discrete[0]))[..., 0]
        out[dev] = [a.double().cpu() for a in (vals, lp, mu)]
    (kg_g, lp_g, mu_g), (kg_c, lp_c, mu_c) = out[DEVICE], out["cpu"]
    errs = {"kg_abs": (kg_g - kg_c).abs().max().item(),
            "log_posterior_rel": ((lp_g - lp_c).abs() /
                                  lp_c.abs().clamp_min(1.0)).max().item(),
            "posterior_mean_abs": (mu_g - mu_c).abs().max().item()}
    ok = errs["kg_abs"] < 1e-3 and errs["log_posterior_rel"] < 1e-3 and \
        errs["posterior_mean_abs"] < 1e-3
    emit({"phase": "small_reference", "n": n, "S": s, "B": b, "M": m,
          "kg_gpu": kg_g.tolist(), "kg_cpu_f64": kg_c.tolist(), **errs,
          "tolerance": "abs 1e-3 (KG, posterior mean), rel 1e-3 (LML)",
          "ok": ok})
    check(ok, "card float32 path disagrees with the float64 CPU path")

    ds, nd = DKG_DERIVATIVES, 12
    xd = rng.random((nd, 2))
    yd = np.stack([np.sin(3 * xd[:, 0]) + xd[:, 1], 3 * np.cos(3 * xd[:, 0]),
                   np.ones(nd)], axis=1)
    yd[:, 0] -= yd[:, 0].mean()
    yd /= yd[:, 0].std()
    noises_d = np.full((s, 1 + len(ds)), 1e-2)
    xt = rng.random((5, 2))
    normals_d = rng.standard_normal((m, Q * (1 + len(ds))))
    out = {}
    for dev, dt in ((DEVICE, torch.float32), ("cpu", torch.float64)):
        def t(a):
            return torch.as_tensor(a, device=dev, dtype=dt)
        states = mcmc.fit_gp_ensemble("matern_2.5", t(hypers), t(noises_d),
                                      xd, yd, ds, bucket=16)
        dom = TensorProductDomain.from_bounds([[0.0, 1.0]] * 2, device=dev,
                                              dtype=dt)
        vals = kg.knowledge_gradient_batch(
            states, t(unions), t(discrete), t(normals_d), dom,
            DEFAULT_SGD_PARAMS_PS,
            torch.full((s,), float(yd[:, 0].min()), device=dev, dtype=dt),
            derivatives_to_sample=ds)
        out[dev] = [a.double().cpu() for a in (
            vals, kg.gp_mod.posterior_mean(states, t(xt), ds),
            kg.gp_mod.posterior_variance(states, t(xt), ds))]
    errs = {name: ((g - c).abs().max() / c.abs().max().clamp_min(1.0)).item()
            for name, g, c in zip(("kg", "posterior_mean",
                                   "posterior_variance"),
                                  out[DEVICE], out["cpu"])}
    ok = all(e < 1e-3 for e in errs.values())
    emit({"phase": "small_reference_dkg", "n": nd, "derivatives": list(ds),
          "k_side": 16 * (1 + len(ds)), "S": s, "B": b, "M": m,
          "kg_gpu": out[DEVICE][0].tolist(),
          "kg_cpu_f64": out["cpu"][0].tolist(),
          "max_err_over_scale": errs,
          "tolerance": "max |f32 card - f64 CPU| <= 1e-3 max(1, max |f64|)",
          "ok": ok})
    check(ok, "card float32 d-KG path disagrees with the float64 CPU path")

    # cf-KG: 40 points in [0, 1] x [0.05, 1], the last coordinate a
    # fidelity; one batch of KG values with the fidelity pinned inside
    xf = rng.random((n, 2))
    xf[:, 1] = 0.05 + 0.95 * xf[:, 1]
    yf = np.sin(3 * xf[:, 0]) * (0.5 + 0.5 * xf[:, 1])
    yf = (yf - yf.mean()) / yf.std()
    unions_f = rng.random((b, Q, 2))
    unions_f[..., 1] = 0.05 + 0.95 * unions_f[..., 1]
    discrete_f = rng.random((s, 11, 1))
    out = {}
    for dev, dt in ((DEVICE, torch.float32), ("cpu", torch.float64)):
        def t(a):
            return torch.as_tensor(a, device=dev, dtype=dt)
        states = mcmc.fit_gp_ensemble("matern_2.5", t(hypers), t(noises),
                                      xf, yf[:, None], bucket=16)
        dom = TensorProductDomain.from_bounds([[0.0, 1.0]], device=dev,
                                              dtype=dt)
        out[dev] = kg.knowledge_gradient_mcmc_batch(
            states, t(unions_f), t(discrete_f), t(normals), dom,
            DEFAULT_SGD_PARAMS_PS,
            torch.full((s,), float(yf.min()), device=dev, dtype=dt),
            num_fidelity=1)
    kg_g, kg_c = out[DEVICE].double().cpu(), out["cpu"]
    err = ((kg_g - kg_c).abs().max() /
           kg_c.abs().max().clamp_min(1.0)).item()
    emit({"phase": "small_reference_cfkg", "n": n, "num_fidelity": 1,
          "S": s, "B": b, "M": m, "kg_gpu": kg_g.tolist(),
          "kg_cpu_f64": kg_c.tolist(), "max_err_over_scale": err,
          "tolerance": "max |f32 card - f64 CPU| <= 1e-3 max(1, max |f64|)",
          "ok": err < 1e-3})
    check(err < 1e-3, "card float32 cf-KG path disagrees with the float64 "
                      "CPU path")

    # PES: 8 points in [0, 1]^2, 4 hyperparameter sets, the multi-set
    # acquisition at 16 points (PERF.md states why the tolerance is wider)
    from cornell_moe_tpu_torch.acquisition import pes
    rp = np.random.default_rng(0)
    xp = rp.random((8, 2))
    yp = np.sin(3 * xp[:, 0]) + xp[:, 1] ** 2
    yp = (yp - yp.mean()) / yp.std()
    x_min = rp.random((4, 2))
    a = rp.standard_normal((4, 2, 2))
    hess = a @ a.transpose(0, 2, 1) + 2 * np.eye(2)
    sigma, lengths = 1.0 + 0.5 * rp.random(4), 0.3 + 0.2 * rp.random((4, 2))
    pts = rp.random((16, 2))
    out = {}
    for dev, dt in ((DEVICE, torch.float32), ("cpu", torch.float64)):
        def t(a_):
            return torch.as_tensor(a_, device=dev, dtype=dt)
        st = pes.make_pes_state(t(xp), t(yp), t(x_min), t(hess), t(sigma),
                                t(lengths), t(np.full(4, 1e-2)))
        out[dev] = pes.pes_acquisition_multi(t(pts), st, t(xp)).double(
        ).cpu()
    pes_g, pes_c = out[DEVICE], out["cpu"]
    err = ((pes_g - pes_c).abs().max() /
           pes_c.abs().max().clamp_min(1.0)).item()
    ok = bool(torch.isfinite(pes_g).all()) and err < 1e-2
    emit({"phase": "small_reference_pes", "n": 8, "d": 2, "sets": 4,
          "points": 16, "acq_gpu": pes_g.tolist(),
          "acq_cpu_f64": pes_c.tolist(), "max_err_over_scale": err,
          "tolerance": "max |f32 card - f64 CPU| <= 1e-2 max(1, max |f64|)",
          "ok": ok})
    check(ok, "card float32 PES acquisition disagrees with the float64 CPU "
              "path")

def _domain_check(points, bounds) -> bool:
    import numpy as np
    p = np.atleast_2d(points)
    return bool(np.isfinite(p).all() and ((p >= bounds[:, 0]) &
                                          (p <= bounds[:, 1])).all())


def phase_ei(torch):
    """One iteration of ``BayesianOptimizer(method="EI")`` at the main
    path's size and data (Branin, 500 observations, 512 after the bucket,
    16 members, q = 4, 200 multistarts, 1024 MC draws, float32, noisy,
    standardized, seed 0): q,p-EI on ensemble member 0.  Every launch
    counter is set to 0 just before and read just after: the chain
    launches B and the ensemble fits C, while the EI suggest and the
    recommendation launch neither A nor D.  The EI suggest's GD step and
    scoring run as programs with the other stages, each replayed, and the
    iteration equals its CAPTURE = "never" twin bit for bit (a NaN VOI
    equal to a NaN).  The VOI, the single-union estimate on member 0 at the
    suggested union, is finite and >= 0 where that union's float32
    posterior variance, jittered as the estimator jitters it, factors, and
    NaN where it does not, as in the JAX package (no repair of an
    indefinite union); the union's factor is recomputed from the state and
    points the scorer was given.  Returns the optimizer."""
    import numpy as np
    from cornell_moe_tpu_torch import config
    from cornell_moe_tpu_torch.acquisition import expected_improvement as ei
    from cornell_moe_tpu_torch.bayes_opt import BayesianOptimizer
    from cornell_moe_tpu_torch.ops import linalg
    from cornell_moe_tpu_torch.utils.synthetic_functions import Branin

    def make_bo():
        return BayesianOptimizer(
            objective_func=Branin(), method="EI", num_to_sample=Q,
            n_hypers=N_HYPERS, noisy=True, standardize=True, device=DEVICE,
            dtype=torch.float32, verbose=False)

    bo = make_bo()
    check(bo.sgd_params.num_multistarts == MULTISTARTS and
          bo.num_mc == EI_NUM_MC, "EI path size changed")
    scored, score = [], ei.evaluate_expected_improvement_at_point_list

    def recording_score(state, points_list, **kw):
        scored.append((state, points_list))
        return score(state, points_list, **kw)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = snapshot()
    ei.evaluate_expected_improvement_at_point_list = recording_score
    try:
        t0 = time.time()
        rec = bo.run(num_iterations=1, num_init_pts=NUM_OBS)[-1]
        torch.cuda.synchronize()
        wall = time.time() - t0
    finally:
        ei.evaluate_expected_improvement_at_point_list = score
    counts = kernel_launches(before)
    peak = torch.cuda.max_memory_allocated()
    _, var = ei._union_posterior(*scored[0])
    voi_union = {
        "factor_finite": bool(torch.isfinite(linalg.cholesky_small(
            linalg.add_jitter(var, config.EI_VARIANCE_JITTER))).all()),
        "least_eigenvalue": torch.linalg.eigvalsh(var.double())[
            ..., 0].min().item(),
        "least_diagonal": torch.diagonal(var, dim1=-2, dim2=-1).min().item()}
    twin = _programs_vs_never(torch, bo, rec, make_bo)
    states = bo.model.models
    bounds = bo.objective_func._search_domain
    sugg, r = rec["suggested"], rec["recommended"]
    emit({"phase": "ei_path", "seconds": wall,
          "stages": {x["phase"]: x["seconds"] for x in bo.timer.records},
          "num_sampled": int(bo.model._data.num_sampled),
          "ensemble": int(states.chol_K.shape[0]),
          "padded_n": int(states.chol_K.shape[-1]), "num_mc": bo.num_mc,
          "chain_steps": bo.model.chain_steps,
          "members_replaced": bo.model.members_replaced,
          "voi": rec["voi"], "suggested": sugg.tolist(),
          "distinct_suggested": int(len(np.unique(sugg, axis=0))),
          "recommended": r.tolist(), "true_value": rec["true_value"],
          "voi_union_float32": voi_union,
          "max_memory_allocated": peak, "launches": counts, **twin})
    _check_programs("EI path", twin, EI_PROGRAM_KINDS)
    check(math.isfinite(rec["voi"]) and rec["voi"] >= 0.0
          if voi_union["factor_finite"] else math.isnan(rec["voi"]),
          f"EI VOI {rec['voi']} neither finite and >= 0 where the union "
          f"factors nor NaN where it does not: {voi_union}")
    check(sugg.shape == (Q, 2) and _domain_check(sugg, bounds),
          f"EI suggestions {sugg} not q points inside the domain")
    check(_domain_check(r, bounds) and math.isfinite(rec["true_value"]),
          f"EI recommendation {r} not finite inside the domain")
    for name in ("descent_run", "descent_run_fma", "descent_grad",
                 "descent_grad_fma"):
        check(counts.get(name, 0) == 0, f"the EI path launched {name}")
    check(counts.get("lml_fused", 0) > 0 and
          counts.get("covariance_with_noise", 0) > 0,
          "the EI path did not launch kernels B and C")
    check(bool(torch.isfinite(states.chol_K).all()),
          "an EI ensemble member's chol_K is non-finite")
    _ei_routes(torch, bo)
    return bo


# the JAX package's test of the two routes (tests/test_expected_improvement
# .py:300-317): 8 starts, 6 steps, q = 2, 64 draws
EI_ROUTE_PARAMS = dict(num_multistarts=8, max_num_steps=6,
                       max_num_restarts=1, num_steps_averaged=3, gamma=0.7,
                       pre_mult=0.3, max_relative_change=0.5)
EI_ROUTE_Q, EI_ROUTE_MC = 2, 64


def _ei_route_picks(torch, states, dom) -> dict:
    """Both routes of ``multistart_expected_improvement_mcmc_optimization``
    on ``states`` from one generator state (seed 5), both eager: their
    picks, seconds and largest difference over the domain's width, and
    each estimator at the starts the routes draw (the batched one, which
    the batched route steps on, and the single-union one, which the
    per-start route steps on; both NaN where a union's float32 factor
    fails)."""
    from cornell_moe_tpu_torch.acquisition import expected_improvement as ei
    from cornell_moe_tpu_torch.ops import optimizers
    from cornell_moe_tpu_torch.ops.domains import RepeatedDomain

    params = optimizers.GradientDescentParameters(**EI_ROUTE_PARAMS)
    dev = states.chol_K.device
    picks, seconds = {}, {}
    for label, batched in (("batched", True), ("per_start", False)):
        torch.cuda.synchronize()
        t0 = time.time()
        picks[label] = ei.multistart_expected_improvement_mcmc_optimization(
            torch.Generator(device=dev).manual_seed(5), states, dom,
            EI_ROUTE_Q, params, num_mc_iterations=EI_ROUTE_MC,
            use_batched=batched)
        torch.cuda.synchronize()
        seconds[label] = time.time() - t0
    g = torch.Generator(device=dev).manual_seed(5)
    starts = RepeatedDomain(domain=dom, num_repeats=EI_ROUTE_Q
                            ).generate_latin_hypercube_points(
                                g, EI_ROUTE_PARAMS["num_multistarts"])
    normals = ei.draw_normals(g, EI_ROUTE_MC, EI_ROUTE_Q, device=dev,
                              dtype=starts.dtype)
    best = states.best_observed_value
    width = dom.upper - dom.lower
    batched = ei.monte_carlo_expected_improvement_mcmc_batch(
        states, starts, None, best, normals)
    return {"picks": {k: v.tolist() for k, v in picks.items()},
            "seconds": seconds,
            "max_abs_diff_over_width": (
                (picks["batched"] - picks["per_start"]).abs() / width
            ).max().item(),
            "at_starts": {
                "batched_estimator": batched.tolist(),
                "single_union_estimator": [
                    ei.monte_carlo_expected_improvement_mcmc(
                        states, u, None, best, normals).item()
                    for u in starts]}}


def _ei_routes(torch, bo) -> None:
    """``multistart_expected_improvement_mcmc_optimization``'s batched and
    per-start routes (``use_batched``) at the JAX test's size
    (:func:`_ei_route_picks`), in float32 on the card: on the JAX test's
    own problem (tests/test_expected_improvement.py:247-256 and :300-317:
    3 members, 12 points, noise 1e-3), where the two picks must be within
    1e-3 of the domain's width of each other, and on the EI path's
    ensemble (the main path's size: 16 members, Np 512), where they must
    agree too: there q-EI sits below float32's resolution and a union's
    float32 variance can be indefinite, which both estimators leave to
    fail (NaN, a start the multistarts drop), as the JAX package's do."""
    import numpy as np
    from cornell_moe_tpu_torch.models import mcmc as mcmc_mod
    from cornell_moe_tpu_torch.ops.domains import TensorProductDomain

    r = np.random.default_rng(7)
    x = r.random((12, 2))
    y = np.sin(3 * x[:, 0]) + x[:, 1] ** 2
    kw = dict(device=DEVICE, dtype=torch.float32)
    small = mcmc_mod.fit_gp_ensemble(
        "matern_2.5", torch.as_tensor(np.abs(r.standard_normal((3, 3))) +
                                      0.7, **kw),
        torch.full((3, 1), 1e-3, **kw), x, y[:, None])
    line = {"phase": "ei_routes", "params": EI_ROUTE_PARAMS,
            "num_to_sample": EI_ROUTE_Q, "num_mc": EI_ROUTE_MC,
            "jax_test_problem": _ei_route_picks(
                torch, small, TensorProductDomain.from_bounds(
                    [[0.0, 1.0]] * 2, **kw)),
            "ei_path_ensemble": _ei_route_picks(torch, bo.model.models,
                                                bo.domain),
            "tolerance": "1e-3 of the domain's width on each problem"}
    emit(line)
    for problem in ("jax_test_problem", "ei_path_ensemble"):
        err = line[problem]["max_abs_diff_over_width"]
        check(err <= 1e-3, f"the per-start EI-MCMC route's pick is off the "
                           f"batched route's on the {problem}: {line}")


def phase_covariance_methods(torch) -> None:
    """``StationaryCovariance.grad_covariance`` (dk/dx) in float32 on the
    card against ``torch.autograd`` of ``covariance``, both kernels, 16
    kernels of random hyperparameters at one point pair each (one pair
    coincident): within 1e-5 of the gradient's largest entry."""
    from cornell_moe_tpu_torch.models import covariance as cov_mod

    g = torch.Generator(device=DEVICE).manual_seed(3)
    kw = dict(device=DEVICE, dtype=torch.float32)
    h = torch.cat([0.5 + torch.rand((16, 1), generator=g, **kw),
                   0.3 + torch.rand((16, 2), generator=g, **kw)], dim=1)
    x = torch.rand((16, 2), generator=g, **kw)
    y = torch.rand((16, 2), generator=g, **kw)
    y[0] = x[0]
    line = {"phase": "covariance_methods", "kernels": {}}
    for name, cls in cov_mod.COVARIANCE_TYPES.items():
        cov = cls(hyperparameters=h)
        got = cov.grad_covariance(x, y)
        xx = x.clone().requires_grad_(True)
        (ref,) = torch.autograd.grad(cov.covariance(xx, y).sum(), xx)
        err = (got - ref).abs().max().item()
        scale = ref.abs().max().item()
        line["kernels"][name] = {
            "max_abs_err": err, "scale": scale,
            "num_hyperparameters": cov.num_hyperparameters,
            "coincident_zero": bool((got[0] == 0).all()),
            "ok": err <= 1e-5 * scale and bool((got[0] == 0).all())}
    line["tolerance"] = "1e-5 of the largest |dk/dx|; 0 at coincident points"
    emit(line)
    check(all(v["ok"] for v in line["kernels"].values()),
          f"grad_covariance disagrees with autograd: {line}")


def phase_heuristic_ei(torch, bo) -> None:
    """Heuristic q-EI (q = 4) on member 0 of the EI path's ensemble, under
    the kriging believer and under the constant liar (the lie: the best
    observed value), with the driver's multistart parameters, through one
    program cache: the refit at n0 + q = 516 points is one program (kernel
    C at S 1, n 516, d 2), built once and replayed five times per policy,
    and each round's multistart takes its GD steps through the EI step's
    program; C's launches and their shapes are counted through the
    replays.  Then both policies again from the same generator state with
    ``programs.CAPTURE = "never"``, equal bit for bit, and C against its
    plain version on that run's last refit's own inputs."""
    import functools

    import numpy as np
    from cornell_moe_tpu_torch.acquisition import expected_improvement as ei
    from cornell_moe_tpu_torch.ops import kernels, programs
    from cornell_moe_tpu_torch.utils import logging_utils

    member = bo.model.models.member(0)
    bounds = bo.objective_func._search_domain
    last = {}
    covariance = kernels.covariance_with_noise
    # C's calls by shape, counted in the registry so that replays add them
    by_shape = "chip_smoke.covariance_with_noise."

    def recording_covariance(points, hypers, noise, kernel_name):
        logging_utils.count(f"{by_shape}S{hypers.shape[0]}_n"
                            f"{points.shape[0]}_d{points.shape[1]}")
        last["args"] = (points, hypers, noise, kernel_name)
        return covariance(points, hypers, noise, kernel_name)

    policies = {
        "kriging_believer": None,
        "constant_liar": functools.partial(
            ei.constant_liar_estimate,
            lie_value=float(member.best_observed_value))}

    def run_policies(cache):
        picks, seconds = {}, {}
        for name, policy in policies.items():
            t0 = time.time()
            pts = ei.heuristic_expected_improvement_optimization(
                bo.generator, member, bo.domain, Q, bo.sgd_params,
                estimation_policy=policy, num_mc_iterations=bo.num_mc,
                program_cache=cache)
            torch.cuda.synchronize()
            seconds[name] = time.time() - t0
            picks[name] = pts.cpu().numpy()
        return picks, seconds

    cache = programs.ProgramCache()
    gen_state = bo.generator.get_state()
    torch.cuda.synchronize()
    before = snapshot()
    kernels.covariance_with_noise = recording_covariance
    try:
        picks, seconds = run_policies(cache)
        counts = kernel_launches(before)
        shapes_with_programs = {
            name[len(by_shape):]: n
            for name, n in logging_utils.growth(before).items()
            if name.startswith(by_shape)}
        by_kind = programs.by_kind(cache)
        cache.release()
        bo.generator.set_state(gen_state)
        programs.CAPTURE = "never"
        try:
            never, never_seconds = run_policies(None)
        finally:
            programs.CAPTURE = "auto"
    finally:
        kernels.covariance_with_noise = covariance
    n_refit = member.num_sampled + Q
    equal = {k: bool(np.array_equal(picks[k], never[k])) for k in picks}
    emit({"phase": "heuristic_ei", "q": Q, "seconds": seconds,
          "never_seconds": never_seconds,
          "picks": {k: v.tolist() for k, v in picks.items()},
          "refit_n": n_refit,
          "covariance_launches_by_shape": shapes_with_programs,
          "launches": counts, "programs": by_kind,
          "bitwise_equal_to_never": equal})
    for name, pts in picks.items():
        check(pts.shape == (Q, 2) and _domain_check(pts, bounds),
              f"heuristic q-EI ({name}) picks {pts} outside the domain")
    check(n_refit == 516 and
          shapes_with_programs == {f"S1_n{n_refit}_d2": 2 * (1 + Q)},
          f"heuristic q-EI refits {shapes_with_programs}, expected 10 at "
          "S1_n516_d2")
    check(counts.get("covariance_with_noise", 0) == 2 * (1 + Q),
          "the heuristic refits did not launch kernel C")
    check(by_kind.get("heuristic_refit") == {"builds": 1,
                                             "replays": 2 * (1 + Q)} and
          by_kind.get("ei_step", {}).get("replays", 0) > 0,
          f"the heuristic programs did not replay: {by_kind}")
    check(all(equal.values()),
          f"heuristic q-EI with programs and CAPTURE = 'never' differ: "
          f"{equal}")
    x, h, nv, kernel_name = last["args"]
    _covariance_line(torch, "heuristic_ei", x, h, nv, kernel_name)


def phase_map(torch, bo) -> None:
    """The MAP fit, ``optimize(num_restarts=4)``, on the EI path's model:
    a damped Newton from each of 4 prior draws over the plain log
    posterior.  Kernel B has no backward, so the fit may not launch it;
    its launches are read from just before.  The chosen
    point must be the best finite end (its log posterior that end's, bit
    for bit), or, when no end is finite, start 0 bit for bit, as the JAX
    package keeps it.  Each start's 40 Newton steps are one program of the
    driver's cache, built once and replayed per start; the fit again from
    the same generator state with ``programs.CAPTURE = "never"`` must give
    the same ends and the same pick bit for bit."""
    import numpy as np
    from cornell_moe_tpu_torch.ops import programs

    model = bo.model
    gen_state = model.generator.get_state()
    torch.cuda.synchronize()
    before = snapshot()
    t0 = time.time()
    model.optimize(num_restarts=MAP_RESTARTS)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = kernel_launches(before)
    newton = programs.by_kind(model.program_cache).get(
        "map_newton")
    got = (np.asarray(model.hypers), model.map_values.cpu().numpy())
    model.generator.set_state(gen_state)
    programs.CAPTURE = "never"
    try:
        t1 = time.time()
        model.optimize(num_restarts=MAP_RESTARTS)
        torch.cuda.synchronize()
        never_wall = time.time() - t1
    finally:
        programs.CAPTURE = "auto"
    equal = {k: bool(np.array_equal(a, b, equal_nan=True)) for k, a, b in zip(
        ("hypers", "end_log_posteriors"), got,
        (np.asarray(model.hypers), model.map_values.cpu().numpy()))}
    x, y, pn = model._padded_data()

    def log_posterior(theta):                   # one row, as optimize()
        return model.log_posterior(theta[None], x, y, pn,
                                   force_plain=True)[0]

    start_lp = torch.stack([log_posterior(t) for t in model.map_starts])
    ends = model.map_values
    finite = torch.isfinite(ends)
    chosen = float(log_posterior(torch.as_tensor(
        model.hypers[0], dtype=x.dtype, device=x.device)))
    best_start = float(start_lp.max())
    emit({"phase": "map_path", "seconds": wall, "restarts": MAP_RESTARTS,
          "finite_ends": int(finite.sum()), "end_log_posteriors":
              [float(v) for v in ends], "start_log_posteriors":
              [float(v) for v in start_lp], "chosen_log_posterior": chosen,
          "best_start_log_posterior": best_start,
          "chosen_from": "end" if bool(finite.any()) else "start_0",
          "hypers": model.hypers.tolist(), "launches": counts,
          "never_seconds": never_wall, "map_newton_program": newton,
          "bitwise_equal_to_never": equal})
    check(counts.get("lml_fused", 0) == 0 and
          counts.get("lml_fused_global", 0) == 0,
          "the MAP fit launched kernel B")
    check(newton == {"builds": 1, "replays": MAP_RESTARTS},
          f"the Newton program did not replay once per start: {newton}")
    check(all(equal.values()),
          f"the MAP fit with programs and CAPTURE = 'never' differ: {equal}")
    if bool(finite.any()):
        best_end = float(ends[finite].max())
        check(chosen == best_end,
              f"MAP point {chosen} is not the best finite end {best_end}")
    else:
        check(np.array_equal(model.hypers[0],
                             model.map_starts[0].cpu().numpy()),
              "no Newton end is finite, and the MAP point is not start 0")
    check(model.num_mcmc == 1 and
          bool(torch.isfinite(model.models.chol_K).all()),
          "the MAP member's fit is not finite")


def phase_checkpoint_resume(torch) -> None:
    """Checkpoint and resume at a reduced depth (Branin, 64 observations,
    8 members, burn-in 200, chain cap 128, method "EI", q = 2): two
    iterations in one run, against one iteration, a checkpoint, a fresh
    driver that resumes from it, and the second iteration.  The second
    iteration's suggested points, VOI and chain steps must agree bit for
    bit."""
    import tempfile

    import numpy as np
    from cornell_moe_tpu_torch.bayes_opt import BayesianOptimizer
    from cornell_moe_tpu_torch.utils.synthetic_functions import Branin

    def driver(path=None):
        return BayesianOptimizer(
            objective_func=Branin(), method="EI", num_to_sample=CKPT_Q,
            n_hypers=CKPT_HYPERS, noisy=True, standardize=True,
            burnin_steps=CKPT_BURNIN, chain_length=CKPT_CHAIN,
            checkpoint_path=path, device=DEVICE, dtype=torch.float32,
            verbose=False)

    t0 = time.time()
    whole = driver()
    ref = whole.run(2, num_init_pts=CKPT_OBS)[1]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "run.ckpt")
        first = driver(path)
        first.run(1, num_init_pts=CKPT_OBS)
        release(torch, first)
        resumed = driver(path)
        meta = resumed.resume()
        got = resumed.run(2, start_iteration=1)[-1]
    torch.cuda.synchronize()
    for bo in (whole, resumed):
        release(torch, bo)
    same = {"suggested": bool(np.array_equal(got["suggested"],
                                             ref["suggested"])),
            "voi": got["voi"] == ref["voi"],
            "chain_steps": resumed.model.last_chain_steps ==
            whole.model.last_chain_steps,
            "recommended": bool(np.array_equal(got["recommended"],
                                               ref["recommended"]))}
    emit({"phase": "checkpoint_resume", "seconds": time.time() - t0,
          "observations": CKPT_OBS, "members": CKPT_HYPERS,
          "burnin_steps": CKPT_BURNIN, "chain_cap": CKPT_CHAIN,
          "q": CKPT_Q, "resumed_after_iteration": meta["iteration"],
          "suggested": got["suggested"].tolist(), "voi": got["voi"],
          "chain_steps": resumed.model.last_chain_steps,
          "uninterrupted": {"suggested": ref["suggested"].tolist(),
                            "voi": ref["voi"],
                            "chain_steps": whole.model.last_chain_steps},
          "bitwise_equal": same})
    check(all(same.values()),
          f"the resumed run's second iteration differs: {same}")


def phase_cli(torch) -> None:
    """The command line, in-process on the card at its own defaults:
    ``Branin EI 2 1 none 0 1``, ``Hartmann6 EI 1 1 HeSBO 2 1`` and
    ``KISSGP KG 1 1 none 0 1`` (d-KG on the real-function objective, 3
    gradient channels).  Each must return 0; their printed output is
    captured and its last lines printed."""
    import contextlib
    import io

    from cornell_moe_tpu_torch import main as cli

    runs = {}
    for args in (["Branin", "EI", "2", "1", "none", "0", "1"],
                 ["Hartmann6", "EI", "1", "1", "HeSBO", "2", "1"],
                 ["KISSGP", "KG", "1", "1", "none", "0", "1"]):
        out = io.StringIO()
        t0 = time.time()
        with contextlib.redirect_stdout(out):
            rc = cli.main(["cornell_moe_tpu_torch.main"] + args)
        torch.cuda.synchronize()
        lines = out.getvalue().strip().splitlines()
        runs[" ".join(args)] = {"rc": rc, "seconds": time.time() - t0,
                                "last_line": lines[-1] if lines else ""}
    emit({"phase": "cli", "runs": runs})
    for args, run in runs.items():
        check(run["rc"] == 0 and run["last_line"].startswith(
            "final best recommended value: "),
            f"the command line {args!r} failed: {run}")


# The compat phase's single-GP check points and its chain depth
# (BayesianOptimizer's defaults); the single GP's float32 posterior is held
# to the float64 refit as the LCB phase holds member 0 (LCB_*_RTOL)
COMPAT_POINTS, COMPAT_BURNIN, COMPAT_CHAIN = 100, 2000, 1000
COMPAT_BLOCKS = 8


def phase_compat(torch) -> None:
    """The upstream Cornell-MOE class flow through ``compat`` at the main
    path's full width: Branin on its raw domain, 500 observations (no
    bucket: the compat classes fit the data as given), 16 members, q = 4,
    200 multistarts, 128 MC draws, float32 on the card.
    ``GaussianProcessLogLikelihoodMCMC.train`` (kernel B; the model's fit,
    C) -> ``GaussianProcessMCMC`` from the trained walkers (C at S16 n500)
    -> ``KnowledgeGradientMCMC`` on the main path's seeded discretization
    with ``GradientDescentOptimizer`` and
    ``multistart_knowledge_gradient_mcmc_optimization`` (A), held bit for
    bit to the core's multistart from the same generator state, once with
    q = 4 and once with q = 3 and one point being sampled (A at union
    width 4) -> ``PosteriorMeanMCMC`` polished by
    ``GradientDescentOptimizer`` (the recommendation).  Then the
    single-GP surface on the first member whose float32 factorization
    succeeds with no jitter (the JAX class raises where it fails; the
    singular members are recorded), or on member 0 in float64 on the card
    when none does: ``GaussianProcess`` (C at S1 n500 in float32) against
    its float64 CPU refit at COMPAT_POINTS points, analytic EI and its
    multistart (q = 1), and ``KnowledgeGradient``'s value and gradient at a
    q = 4 union (no kernel).  Last it checks that float32 raises
    ``SingularMatrixError`` on duplicate points with zero noise, as the JAX
    class does (the CPU tests' case; C at S1 n2 d1).  Every launch counter
    is set to 0 at the start and read at the end (each stage's launches
    too, the core comparisons' kept apart).  The ensemble's program cache
    runs its fit, the KG point lists' blocks (COMPAT_BLOCKS blocks of q
    points after each suggest, ``kg_score``) and the recommendation's GD
    steps (``compat_step``) as CUDA graphs; the KG multistart and the VOIs
    run eagerly by their rule.  Last, the suggests, VOIs, point lists and
    the recommendation run again on a refit of the same ensemble with
    ``programs.CAPTURE = "never"``, timed, and equal bit for bit."""
    import dataclasses

    import numpy as np
    from cornell_moe_tpu_torch.acquisition import knowledge_gradient as kg
    from cornell_moe_tpu_torch.bayes_opt import (
        DEFAULT_SGD_PARAMS_KG, DEFAULT_SGD_PARAMS_PS,
        DEFAULT_SGD_PARAMS_RECOMMEND, seed_kg_discretization)
    from cornell_moe_tpu_torch.compat import covariance as cov_c
    from cornell_moe_tpu_torch.compat import domain as dom_c
    from cornell_moe_tpu_torch.compat import expected_improvement as ei_c
    from cornell_moe_tpu_torch.compat import gaussian_process as gp_c
    from cornell_moe_tpu_torch.compat import knowledge_gradient as kg_c
    from cornell_moe_tpu_torch.compat import knowledge_gradient_mcmc as kgm_c
    from cornell_moe_tpu_torch.compat import optimization as opt_c
    from cornell_moe_tpu_torch.compat.log_likelihood_mcmc import \
        GaussianProcessLogLikelihoodMCMC
    from cornell_moe_tpu_torch.exceptions import SingularMatrixError
    from cornell_moe_tpu_torch.ops import kernels, programs
    from cornell_moe_tpu_torch.utils.data_containers import HistoricalData
    from cornell_moe_tpu_torch.utils.geometry import ClosedInterval
    from cornell_moe_tpu_torch.utils.synthetic_functions import Branin

    f32 = dict(device=DEVICE, dtype=torch.float32)
    f = Branin()
    bounds = f._search_domain
    r = np.random.default_rng(0)
    x = bounds[:, 0] + r.random((NUM_OBS, 2)) * (bounds[:, 1] - bounds[:, 0])
    y = np.array([f.evaluate_true(p)[0] for p in x])
    params = dataclasses.replace(DEFAULT_SGD_PARAMS_KG,
                                 num_multistarts=MULTISTARTS)
    stages, stage_launches, widths = {}, {}, []
    names = {"A": "descent_run", "B": "lml_fused",
             "C": "covariance_with_noise"}

    def abc(counts):
        return {k: counts.get(v, 0) + counts.get(v + "_fma", 0) +
                counts.get(v + "_global", 0) for k, v in names.items()}

    def stage(name, fn):
        before = snapshot()
        t0 = time.time()
        out = fn()
        torch.cuda.synchronize()
        stages[name] = time.time() - t0
        stage_launches[name] = abc(kernel_launches(before))
        return out

    descent_run = kernels.descent_run

    def recording(xs0, ws, wt, beta, z, us, *args, **kw):
        widths.append(int(us.shape[2]))
        return descent_run(xs0, ws, wt, beta, z, us, *args, **kw)

    torch.cuda.synchronize()
    before = snapshot()
    kernels.descent_run = recording
    try:
        data = HistoricalData(2)
        data.append_historical_data(x, y)
        model = GaussianProcessLogLikelihoodMCMC(
            data, chain_length=COMPAT_CHAIN, burnin_steps=COMPAT_BURNIN,
            n_hypers=N_HYPERS, noisy=True, chain_gate_tol=1.0, bucket=16,
            standardize=True, generator=torch.Generator(
                device=DEVICE).manual_seed(0), **f32)
        stage("train", model.train)
        hypers, noises = model._hypers, model._noises
        scaled = HistoricalData(2)
        scaled.append_historical_data(x, model._scaled_values())
        gp_mcmc = stage("gaussian_process_mcmc",
                        lambda: kgm_c.GaussianProcessMCMC(
                            hypers, noises, scaled, **f32))
        domain = dom_c.TensorProductDomain(
            [ClosedInterval(*b) for b in bounds], **f32)
        discrete = stage("discretization", lambda: seed_kg_discretization(
            torch.Generator(device=DEVICE).manual_seed(2), gp_mcmc.states,
            domain.core, conv_tol=3e-3)).cpu().numpy()

        def suggest(num_to_sample, being):
            kg_obj = kgm_c.KnowledgeGradientMCMC(
                gp_mcmc, inner_optimizer=DEFAULT_SGD_PARAMS_PS,
                discrete_pts_list=list(discrete),
                num_to_sample=num_to_sample, num_mc_iterations=NUM_MC,
                points_being_sampled=being, generator=3)
            gen = torch.Generator(device=DEVICE).manual_seed(1)
            state = gen.get_state()
            tag = f"q{num_to_sample}_p{0 if being is None else len(being)}"
            picks = stage("suggest_" + tag, lambda: kgm_c.
                          multistart_knowledge_gradient_mcmc_optimization(
                              opt_c.GradientDescentOptimizer(
                                  domain, kg_obj, params), generator=gen))
            gen.set_state(state)
            core = stage("core_" + tag, lambda: kg.
                         multistart_knowledge_gradient_mcmc_optimization(
                             gen, gp_mcmc.states, domain.core,
                             num_to_sample, params, DEFAULT_SGD_PARAMS_PS,
                             kg_obj._discrete_pts,
                             points_being_sampled=kg_obj._being(),
                             best_so_far=kg_obj._best_so_far_list,
                             num_mc_iterations=NUM_MC)).cpu().numpy()
            kg_obj.set_current_point(picks)
            voi = stage("voi_" + tag, kg_obj.compute_knowledge_gradient_mcmc)
            point_lists[tag] = stage(
                "point_list_" + tag,
                lambda: kg_obj.evaluate_at_point_list(
                    blocks[:, :num_to_sample]))
            return picks, core, voi

        # COMPAT_BLOCKS candidate blocks of q points for the point lists
        blocks = bounds[:, 0] + np.random.default_rng(1).random(
            (COMPAT_BLOCKS, Q, 2)) * (bounds[:, 1] - bounds[:, 0])
        point_lists = {}
        width_start = len(widths)
        picks, core, voi = suggest(Q, None)
        widths_q = sorted(set(widths[width_start:]))
        width_start = len(widths)
        picks_b, core_b, voi_b = suggest(Q - 1, picks[:1])
        widths_qp = sorted(set(widths[width_start:]))

        ps = kgm_c.PosteriorMeanMCMC(gp_mcmc)
        ps.set_current_point(data.best_point)
        start_value = ps.compute_objective_function()
        recommended = stage("recommend", opt_c.GradientDescentOptimizer(
            domain, ps, DEFAULT_SGD_PARAMS_RECOMMEND).optimize)
        rec_value = ps.compute_objective_function()

        # the single GP on the first member that float32 factors with no
        # jitter (as the JAX class fits it), the ones before it recorded;
        # when none does, member 0 in float64 on the card
        member, singular_members, card_kw = {}, [], f32
        for index in range(len(hypers)):
            try:
                member["card"] = stage(
                    "gaussian_process_card", lambda: gp_c.GaussianProcess(
                        cov_c.MaternNu2p5(hypers[index], **f32),
                        noises[index], scaled))
                break
            except SingularMatrixError:
                singular_members.append(index)
        if "card" not in member:
            index, card_kw = 0, dict(device=DEVICE, dtype=torch.float64)
            member["card"] = stage(
                "gaussian_process_card", lambda: gp_c.GaussianProcess(
                    cov_c.MaternNu2p5(hypers[0], **card_kw), noises[0],
                    scaled))
        member["cpu64"] = stage(
            "gaussian_process_cpu64", lambda: gp_c.GaussianProcess(
                cov_c.MaternNu2p5(hypers[index], device="cpu",
                                  dtype=torch.float64),
                noises[index], scaled))
        pts = bounds[:, 0] + r.random((COMPAT_POINTS, 2)) * (
            bounds[:, 1] - bounds[:, 0])
        mu, mu64 = (member[k].compute_mean_of_points(pts)
                    for k in ("card", "cpu64"))
        var, var64 = (member[k].compute_variance_of_points(pts)
                      for k in ("card", "cpu64"))
        alpha = float(hypers[index][0])
        errs = {"posterior_mean": float(np.max(np.abs(mu - mu64))) / max(
                    1.0, float(np.max(np.abs(mu64)))),
                "posterior_variance": float(np.max(np.abs(var - var64))) /
                alpha}
        gp = member["card"]
        ei = ei_c.ExpectedImprovement(gp, points_to_sample=[data.best_point])
        ei_start = ei.compute_expected_improvement()
        ei_pick = stage("ei_multistart", lambda: ei_c.
                        multistart_expected_improvement_optimization(
                            opt_c.GradientDescentOptimizer(domain, ei,
                                                           params),
                            num_to_sample=1))
        ei.set_current_point(ei_pick)
        ei_value = ei.compute_expected_improvement()
        kg_one = kg_c.KnowledgeGradient(gp, DEFAULT_SGD_PARAMS_PS,
                                        discrete[0], points_to_sample=picks,
                                        num_mc_iterations=NUM_MC)
        kg_value = stage("knowledge_gradient",
                         kg_one.compute_knowledge_gradient)
        kg_grad = stage("knowledge_gradient_grad",
                        kg_one.compute_grad_knowledge_gradient)
        # the CPU tests' singular case, duplicate points with zero noise:
        # float32 raises, as the JAX class does (no jitter)
        duplicate = HistoricalData(1)
        duplicate.append_historical_data(np.array([[0.5], [0.5]]),
                                         np.array([1.0, 1.0]))
        try:
            gp_c.GaussianProcess(cov_c.SquareExponential([1.0, 1.0], **f32),
                                 [0.0], duplicate)
            singular = "factored"
        except SingularMatrixError:
            singular = "raised SingularMatrixError"
    finally:
        kernels.descent_run = descent_run
    launches = abc(kernel_launches(before))
    comparisons = {k: sum(v[k] for s_, v in stage_launches.items()
                          if s_.startswith("core_")) for k in names}
    bitwise = {"q4": bool(np.array_equal(picks, core)),
               "q3_p1": bool(np.array_equal(picks_b, core_b))}
    by_kind = programs.by_kind(gp_mcmc.program_cache)

    # the same stages with CAPTURE = "never" on the same ensemble, refitted
    programs.CAPTURE = "never"
    seconds_never = {}
    try:
        def eager(name, fn):
            t0 = time.time()
            out = fn()
            torch.cuda.synchronize()
            seconds_never[name] = time.time() - t0
            return out

        gp_never = eager("gaussian_process_mcmc",
                         lambda: kgm_c.GaussianProcessMCMC(
                             hypers, noises, scaled, **f32))
        never = {}
        for num_to_sample, being in ((Q, None), (Q - 1, picks[:1])):
            kg_obj = kgm_c.KnowledgeGradientMCMC(
                gp_never, inner_optimizer=DEFAULT_SGD_PARAMS_PS,
                discrete_pts_list=list(discrete),
                num_to_sample=num_to_sample, num_mc_iterations=NUM_MC,
                points_being_sampled=being, generator=3)
            tag = f"q{num_to_sample}_p{0 if being is None else len(being)}"
            never["picks_" + tag] = eager("suggest_" + tag, lambda: kgm_c.
                multistart_knowledge_gradient_mcmc_optimization(
                    opt_c.GradientDescentOptimizer(domain, kg_obj, params),
                    generator=torch.Generator(device=DEVICE).manual_seed(1)))
            kg_obj.set_current_point(never["picks_" + tag])
            never["voi_" + tag] = eager(
                "voi_" + tag, kg_obj.compute_knowledge_gradient_mcmc)
            never["point_list_" + tag] = eager(
                "point_list_" + tag,
                lambda: kg_obj.evaluate_at_point_list(
                    blocks[:, :num_to_sample]))
        ps_never = kgm_c.PosteriorMeanMCMC(gp_never)
        ps_never.set_current_point(data.best_point)
        never["recommended"] = eager(
            "recommend", opt_c.GradientDescentOptimizer(
                domain, ps_never, DEFAULT_SGD_PARAMS_RECOMMEND).optimize)
    finally:
        programs.CAPTURE = "auto"
    check(len(gp_never.program_cache) == 0,
          "the compat flow built programs under CAPTURE = 'never'")
    with_programs = {"picks_q4_p0": picks, "voi_q4_p0": voi,
                     "picks_q3_p1": picks_b, "voi_q3_p1": voi_b,
                     "recommended": recommended,
                     **{"point_list_" + k: v for k, v in point_lists.items()}}
    bitwise_never = {k: bool(np.array_equal(np.asarray(v),
                                            np.asarray(never[k])))
                     for k, v in with_programs.items()}
    emit({"phase": "compat_path", "num_sampled": NUM_OBS,
          "ensemble": int(gp_mcmc.num_mcmc), "q": Q,
          "multistarts": MULTISTARTS, "num_mc": NUM_MC,
          "chain_steps": model.chain_steps,
          "members_replaced": model.members_replaced,
          "picks": picks.tolist(), "voi": voi,
          "picks_with_point_being_sampled": picks_b.tolist(),
          "point_being_sampled": picks[:1].tolist(),
          "voi_with_point_being_sampled": voi_b,
          "bitwise_equal_to_core": bitwise,
          "descent_run_union_widths": {"q4": widths_q, "q3_p1": widths_qp},
          "recommended": recommended.tolist(),
          "recommended_neg_mean": rec_value,
          "start_neg_mean": start_value,
          "max_err_over_scale": errs,
          "tolerance": f"|mu32 - mu64| <= {LCB_MEAN_RTOL} max(1, max "
                       f"|mu64|); |var32 - var64| <= {LCB_VARIANCE_RTOL} "
                       "alpha, at every pair of the points",
          "ei_at_best_point": ei_start, "ei_pick": ei_pick.tolist(),
          "ei_at_pick": ei_value, "single_gp_kg": kg_value,
          "single_gp_kg_grad": kg_grad.tolist(),
          "duplicate_points_zero_noise_float32": singular,
          "single_gp_member": index,
          "single_gp_dtype": str(card_kw["dtype"]),
          "members_singular_in_float32": singular_members,
          "launches": launches,
          "launches_of_the_core_comparisons": comparisons,
          "launches_by_stage": stage_launches, "seconds": stages,
          "programs": by_kind, "seconds_never": seconds_never,
          "bitwise_equal_to_never": bitwise_never})
    for kind in ("fit", "kg_score", "compat_step"):
        check(by_kind.get(kind, {}).get("replays", 0) > 0,
              f"the compat path did not replay its {kind} program: "
              f"{by_kind}")
    check(not {"kg_cold", "kg_warm_step"} & set(by_kind),
          f"the compat KG multistart built programs against its rule: "
          f"{by_kind}")
    check(all(bitwise_never.values()),
          f"the compat path with programs and CAPTURE = 'never' differ: "
          f"{bitwise_never}")
    for k in names:
        check(launches[k] - comparisons[k] > 0,
              f"the compat path did not launch kernel {k}")
    check(all(bitwise.values()),
          f"the compat picks differ from the core's: {bitwise}")
    check(widths_q == [Q] and widths_qp == [Q],
          f"kernel A's union widths {widths_q} / {widths_qp}, expected "
          f"[{Q}] with and without a point being sampled")
    check(_domain_check(picks, bounds) and _domain_check(picks_b, bounds) and
          picks.shape == (Q, 2) and picks_b.shape == (Q - 1, 2),
          "compat picks are not q points inside the domain")
    check(math.isfinite(voi) and math.isfinite(voi_b),
          f"compat VOI not finite: {voi}, {voi_b}")
    check(_domain_check(recommended, bounds) and rec_value >= start_value,
          "the compat recommendation left the domain or lost to its start")
    check(errs["posterior_mean"] <= LCB_MEAN_RTOL and
          errs["posterior_variance"] <= LCB_VARIANCE_RTOL,
          f"the card's single GP disagrees with its float64 refit: {errs}")
    check(_domain_check(ei_pick, bounds) and math.isfinite(ei_value) and
          ei_value >= 0.0, f"compat EI pick {ei_pick} ({ei_value}) invalid")
    check(math.isfinite(kg_value) and bool(np.isfinite(kg_grad).all()),
          f"single-GP KG not finite: {kg_value}, {kg_grad}")
    check(singular == "raised SingularMatrixError",
          "float32 factored the duplicate-point, zero-noise matrix: the "
          "JAX class raises SingularMatrixError there")
    check(stage_launches["knowledge_gradient"]["A"] == 0 and
          stage_launches["knowledge_gradient_grad"]["A"] == 0,
          "the single-GP KG launched kernel A")


def phase_f32_robustness(torch) -> None:
    """The float32 robustness grid of tests/test_f32_robustness.py on the
    card (``tools/f32_robustness.py``: its cases, data generator and
    bounds, n = 2000 included): per case the float32 fit against a float64
    fit of the same data on the card, max |dmu| and max |dvar| at 64
    points, the fantasy model's diagonal repair at 16 unions of q = 4, and
    for the KG case the batched KG values in both precisions at 8 unions
    of q = 2 (64 antithetic normals drawn from seed 3).  A non-finite
    float32 Cholesky or a broken bound of the reference fails the run."""
    import numpy as np
    from cornell_moe_tpu_torch.acquisition.expected_improvement import \
        draw_antithetic_normals
    from cornell_moe_tpu_torch.tools import f32_robustness as f32

    cases = []
    for n, ls, dup in f32.CASES:
        rng = np.random.default_rng(0)
        x, y = f32.make_data(rng, n, dup)
        pts = rng.random((64, 2))
        mu32, var32, finite = f32.posterior(x, y, ls, pts, torch.float32,
                                            DEVICE)
        mu64, var64, _ = f32.posterior(x, y, ls, pts, torch.float64, DEVICE)
        rng = np.random.default_rng(0)
        x, y = f32.make_data(rng, n, dup)
        repair, fantasy_finite = f32.fantasy_repair(
            x, y, ls, rng.random((16, 4, 2)), torch.float32, DEVICE)
        cases.append({"n": n, "length_scale": ls, "near_duplicates": dup,
                      "cholesky_finite": finite,
                      "max_abs_mean_error": float(np.max(np.abs(
                          mu32 - mu64))),
                      "max_abs_variance_error": float(np.max(np.abs(
                          var32 - var64))),
                      "repair": repair,
                      "fantasy_cholesky_finite": fantasy_finite})
    n, _, dup = f32.KG_CASE
    rng = np.random.default_rng(0)
    x, y = f32.make_data(rng, n, dup)
    discrete, unions = rng.random((7, 2)), rng.random((8, 2, 2))
    normals = draw_antithetic_normals(
        torch.Generator().manual_seed(3), 64, 2).numpy()
    kg = {str(dt): f32.kg_values(x, y, discrete, unions, normals, dt,
                                 DEVICE)
          for dt in (torch.float32, torch.float64)}
    kg_dev = float(np.max(np.abs(kg["torch.float32"] -
                                 kg["torch.float64"])))
    kg_bound = f32.kg_bound(kg["torch.float64"])
    emit({"phase": "f32_robustness", "cases": cases,
          "bounds": {"mean": f32.MEAN_BOUND, "variance": f32.VARIANCE_BOUND,
                     "repair": f32.REPAIR_BOUND, "kg": kg_bound},
          "kg": {"case": list(f32.KG_CASE),
                 "float32": kg["torch.float32"].tolist(),
                 "float64": kg["torch.float64"].tolist(),
                 "max_abs_error": kg_dev}})
    for c in cases:
        where = f"n={c['n']} ls={c['length_scale']} " \
                f"dup={c['near_duplicates']}"
        check(c["cholesky_finite"] and c["fantasy_cholesky_finite"],
              f"a float32 Cholesky is non-finite at {where}")
        check(c["max_abs_mean_error"] < f32.MEAN_BOUND and
              c["max_abs_variance_error"] < f32.VARIANCE_BOUND,
              f"the float32 posterior breaks the reference's bound at "
              f"{where}: {c}")
        check(c["repair"] < f32.REPAIR_BOUND,
              f"the float32 fantasy repair {c['repair']} breaks the "
              f"reference's bound at {where}")
    check(kg_dev < kg_bound,
          f"float32 KG is {kg_dev} from float64 (bound {kg_bound})")


def phase_small_reference_ei(torch) -> None:
    """The card's float32 EI paths against the port's own float64 CPU path
    on a 12-point problem (S 2, bucket 16): the closed-form EI at 6
    points, MC q-EI (q = 3) on given normals, one heuristic q-EI round
    (its multistart from given starts, then the kriging believer's refit)
    and the LML gradient.  Each within 1e-3 of max(1, max |float64|)."""
    import numpy as np
    from cornell_moe_tpu_torch.acquisition import expected_improvement as ei
    from cornell_moe_tpu_torch.models import covariance as cov_mod
    from cornell_moe_tpu_torch.models import gp as gp_mod
    from cornell_moe_tpu_torch.models import likelihood as lik
    from cornell_moe_tpu_torch.models import mcmc
    from cornell_moe_tpu_torch.ops import optimizers
    from cornell_moe_tpu_torch.ops.domains import (RepeatedDomain,
                                                   TensorProductDomain)

    rng = np.random.default_rng(11)
    n = 12
    x = rng.random((n, 2))
    y = np.sin(3 * x[:, 0]) + x[:, 1] ** 2
    y = (y - y.mean()) / y.std()
    hypers = np.array([[1.2, 0.35, 0.5], [0.8, 0.5, 0.3]])
    pts = rng.random((6, 2))
    blocks = rng.random((4, 3, 2))
    normals = rng.standard_normal((256, 3))
    starts = rng.random((8, 1, 2))
    params = optimizers.GradientDescentParameters(
        num_multistarts=8, max_num_steps=20, max_num_restarts=1,
        num_steps_averaged=5, gamma=0.7, pre_mult=1.0,
        max_relative_change=0.5)
    multistart = ei.multistart_expected_improvement_optimization
    out = {}
    for dev, dt in ((DEVICE, torch.float32), ("cpu", torch.float64)):
        def t(a):
            return torch.as_tensor(a, device=dev, dtype=dt)

        states = mcmc.fit_gp_ensemble("matern_2.5", t(hypers),
                                      t(np.full((2, 1), 1e-2)), x,
                                      y[:, None], bucket=16)
        member = states.member(0)
        dom = TensorProductDomain.from_bounds([[0.0, 1.0]] * 2, device=dev,
                                              dtype=dt)

        def given_starts(generator, state, domain, q, params_,
                         best_so_far=None, num_mc_iterations=None,
                         program_cache=None):
            def bvg(p):
                with torch.enable_grad():
                    xx = p.detach().requires_grad_(True)
                    v = ei.analytic_expected_improvement(state, xx,
                                                         best_so_far)
                    (g,) = torch.autograd.grad(v.sum(), xx)
                return v.detach(), g
            return optimizers.multistart_optimize_batched(
                bvg, RepeatedDomain(domain=domain, num_repeats=1),
                t(starts), params_).best_point

        ei.multistart_expected_improvement_optimization = given_starts
        try:
            pick = ei.heuristic_expected_improvement_optimization(
                None, member, dom, 1, params)
        finally:
            ei.multistart_expected_improvement_optimization = multistart
        value, _ = ei.kriging_believer_estimate(member, pick)
        cov = cov_mod.MaternNu2p5(hyperparameters=t(hypers[0]))
        out[dev] = {
            "analytic_ei": ei.evaluate_expected_improvement_at_point_list(
                member, t(pts)),
            "mc_qei": ei.evaluate_expected_improvement_at_point_list(
                member, t(blocks), normals=t(normals)),
            "heuristic_pick": pick[0],
            "heuristic_fantasy_mean": gp_mod.posterior_mean(
                gp_mod.add_sampled_points(member, pick, value[None, None],
                                          update_mean=False), t(pts))[:, 0],
            "lml_grad": lik.grad_log_marginal_likelihood(
                cov, t([1e-2]), t(x), t(y[:, None]))}
    errs = {k: ((out[DEVICE][k].double().cpu() - c).abs().max() /
                c.abs().max().clamp_min(1.0)).item()
            for k, c in out["cpu"].items()}
    ok = all(e < 1e-3 for e in errs.values())
    emit({"phase": "small_reference_ei", "n": n, "S": 2,
          "values_gpu": {k: v.double().cpu().tolist()
                         for k, v in out[DEVICE].items()},
          "max_err_over_scale": errs,
          "tolerance": "max |f32 card - f64 CPU| <= 1e-3 max(1, max |f64|)",
          "ok": ok})
    check(ok, "card float32 EI paths disagree with the float64 CPU path")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        import cornell_moe_tpu_torch
    except ImportError:
        print("chip_smoke: run it from a checkout of the repository "
              "(cornell_moe_tpu_torch not found)", file=sys.stderr)
        return 2
    pkg_dir = os.path.dirname(os.path.abspath(cornell_moe_tpu_torch.__file__))
    if os.path.dirname(pkg_dir) != HERE:
        print(f"chip_smoke: cornell_moe_tpu_torch imported from {pkg_dir}, "
              "not from this checkout", file=sys.stderr)
        return 2

    provenance(torch)
    phase_build()
    bo, rec, counts = phase_main(torch)
    counts_768 = phase_main_768(torch)
    phase_programs(torch)
    phase_scale_out(torch, bo, rec)
    phase_dkg(torch)
    summary, problems = phase_equivalence(torch, bo.model, counts,
                                          counts_768)
    summary += phase_descent_grad(torch, bo.model.kernel_name, problems)
    summary += phase_lml_chol(torch)
    phase_lcb(torch, bo.model.models)
    del problems
    phase_fantasy_lowp(torch, bo)
    phase_switch_keys(torch, bo)
    release(torch, bo)
    cf = phase_cfkg(torch)
    phase_cfkg_equivalence(torch, cf)
    release(torch, cf)
    del cf
    phase_pes(torch)
    ei_bo = phase_ei(torch)
    phase_heuristic_ei(torch, ei_bo)
    phase_map(torch, ei_bo)
    release(torch, ei_bo)
    del ei_bo
    phase_checkpoint_resume(torch)
    phase_cli(torch)
    phase_compat(torch)
    phase_f32_robustness(torch)
    phase_small_reference(torch)
    phase_small_reference_ei(torch)
    phase_covariance_methods(torch)
    check("jax" not in sys.modules and "cornell_moe_tpu" not in sys.modules,
          "the port imported JAX or the JAX package")
    emit({"kernels": summary})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
