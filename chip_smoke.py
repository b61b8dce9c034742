#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on one NVIDIA GPU.

Run from the root of the repository on a machine with a CUDA card:

    python3 chip_smoke.py

It builds the CUDA kernels of ``cornell_moe_tpu_torch`` from ``csrc/``,
drives one q-KG iteration of ``BayesianOptimizer`` at the main path's size
(Branin, 500 observations, 16-member ensemble, q = 4, 200 multistarts,
128 MC draws, float32 on ``cuda:0``), checks that each kernel of that path
launched during the run, drives the same iteration sharded over
``torch.distributed`` (``BayesianOptimizer(n_devices=)``): a world of one
over NCCL on ``cuda:0``, equal bit for bit to the unsharded iteration, and
a world of two ranks over gloo, both on ``cuda:0`` (one card; NCCL refuses
two ranks on one GPU), each rank counting its own launches of A, B and C,
held to an unsharded iteration with the same chunking, with the latency of
the chain's per-half-step ``all_gather``; then it holds each kernel
against its plain PyTorch version at the main path's shapes (the
covariance also against its own transpose, bit for bit; the fused LML
also against its large-Np instance,
the three timed side by side, with its cluster occupancy; the KG inner
descent in both its instances, tensor-core and FMA, timed in turns).
It drives one d-KG iteration (Branin with both partials observed, the
same size, 3 observation channels per point) and checks that it launched
none of the kernels, as the JAX package takes none on a derivative state.
Then it holds both instances of one descent direction (``descent_grad``,
tensor-core, and ``descent_grad_fma``) against the float64 plain version
and times them in turns, and drives the per-step route of the KG inner
descent (one ``descent_grad`` launch per GD step, the steps taken by
``gradient_ascent_batch``), which the main path does not take, at the main
path's shapes, checks that it went through its kernel, and holds it
against the float64 descent.  It profiles a window of the main path's MCMC
chain (host wall clock per stretch-move step against the device's busy
time).  It drives one continuous-fidelity KG iteration (``BraninFidelity``,
the main path's size, d = 3 with one fidelity dim: kernels B and C, no
kernel A) and holds B and C against their plain versions at that path's
shapes; one LCB batch selection on the main path's ensemble; and one
iteration of ``pes_driver.run_PES`` on Hartmann6 at the reference scale
(60 points, 100 hyperparameter sets, 1000 features, grid 500).  It
drives one ``BayesianOptimizer(method="EI")`` iteration at the main path's
size (kernels B and C, not A or D), heuristic q-EI on its member 0 under
both estimation policies (C at the refit's ragged n 516, held against its
plain version there), the MAP fit on its model (no launch of B), a
checkpoint and resume at a reduced depth (the resumed iteration equal bit
for bit to an uninterrupted one) and the command line
(``cornell_moe_tpu_torch.main``) on Branin, on Hartmann6 through HeSBO and
on KISSGP (d-KG on a real-function objective).
Last it checks the port against its own float64 CPU path on small inputs:
value-only, with derivative channels, with a fidelity dim, PES and EI.
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
KERNELS = {
    "descent_run": ("cornell_moe_tpu_torch/csrc/descent_run_mma.cu",
                    f"{PALLAS}:495"),
    "descent_run_fma": ("cornell_moe_tpu_torch/csrc/descent_run.cu",
                        f"{PALLAS}:495"),
    "descent_grad": ("cornell_moe_tpu_torch/csrc/descent_grad_mma.cu",
                     f"{PALLAS}:538"),
    "descent_grad_fma": ("cornell_moe_tpu_torch/csrc/descent_grad.cu",
                         f"{PALLAS}:538"),
    "lml_fused": ("cornell_moe_tpu_torch/csrc/lml_fused.cu", f"{PALLAS}:271"),
    "covariance_with_noise": (
        "cornell_moe_tpu_torch/csrc/covariance_with_noise.cu",
        f"{PALLAS}:88"),
}
# the kernels the main path launches (descent_grad and descent_grad_fma
# serve the per-step route, driven by its own phase; every lml_fused launch
# takes the cluster instance, and the large-Np instance, lml_fused_global,
# none; every descent_run launch the tensor-core instance, and the FMA
# instance, descent_run_fma, none)
MAIN_PATH_KERNELS = ("descent_run", "lml_fused", "covariance_with_noise")
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

# Peaks of one H100 SXM at 700 W (data sheet, dense): float32 outside the
# tensor cores, TF32 on the tensor cores, HBM, and the special-function
# (MUFU) units: 16 per SM per clock, 132 SMs at 1.98 GHz
FP32_FLOPS, TF32_FLOPS, HBM_BYTES = 67e12, 495e12, 3.35e12
MUFU_OPS = 16 * 132 * 1.98e9


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


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
    launches sent to ``descent``, every launch counter set to 0 just
    before and read just after).  Returns the optimizer, the record, the
    wall time, the counts, A's launches and B's calls by shape."""
    from cornell_moe_tpu_torch.tools import scale_out
    check(scale_out.NUM_OBS == NUM_OBS and
          scale_out.MAIN_PATH["num_to_sample"] == Q and
          scale_out.MAIN_PATH["n_hypers"] == N_HYPERS,
          "main-path size changed")
    run = scale_out.iteration(DEVICE, descent, **bo_kwargs)
    check(run[0].sgd_params.num_multistarts == MULTISTARTS and
          run[0].num_mc == NUM_MC, "main-path size changed")
    return run


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
    for name in MAIN_PATH_KERNELS:
        check(counts[name] > 0,
              f"kernel {name} was not launched on the main path")
    for name in NOT_ON_MAIN_PATH:
        check(counts[name] == 0, f"the main path launched {name}")
    check(sum(descent_shapes.values()) == counts["descent_run"],
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
    check(wcounts["descent_run"] == 0 and
          wcounts["descent_run_fma"] == sum(wshapes.values()) > 0,
          "the witness run did not send every A launch to the FMA instance")
    check(wbo.model.chain_steps[0] == bo.model.chain_steps[0],
          "the chain before any A launch moved in the witness")
    del wbo
    return bo, rec, counts


def _scale_out_rank() -> dict:
    """One rank of the scale-out phase's gloo group: the main path's
    iteration on cuda:0 with ``n_devices`` = SCALE_OUT_WORLD (the restart
    axis, the walkers and the recommend grid sharded over the ranks), its
    launch counters set to 0 just before and read just after."""
    import torch
    from cornell_moe_tpu_torch.ops import kernels
    from cornell_moe_tpu_torch.tools import scale_out
    out = scale_out.summary(*_iteration(torch, kernels.descent_run,
                                        n_devices=SCALE_OUT_WORLD))
    out["rank"] = torch.distributed.get_rank()
    out["backend"] = str(torch.distributed.get_backend())
    out["all_gather_ms"] = scale_out.gather_ms(
        torch.distributed.group.WORLD, DEVICE, N_HYPERS // 2)
    return out


def phase_scale_out(torch, main_bo, main_rec) -> None:
    """The main path's iteration sharded (``BayesianOptimizer(n_devices=)``,
    ``parallel.sharding``), twice.  (a) A world of one over NCCL on cuda:0,
    the group made by ``n_devices=1`` itself: equal bit for bit to the
    main path's unsharded iteration (its chunk, 200 / 1, is one chunk).
    (b) A world of SCALE_OUT_WORLD ranks over gloo, spawned here, every
    rank on cuda:0 (the machine has one card, and NCCL refuses two ranks on
    one GPU): each rank counts its own launches of A, B and C, the ranks
    must agree bit for bit, and each is held to an unsharded iteration
    with the same chunking (suggest_chunk_size 200 / SCALE_OUT_WORLD)
    within SCALE_OUT_RTOL of each quantity's scale."""
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
                                                N_HYPERS // 2)}
    dist.destroy_process_group()
    one.update(scale_out.summary(*run))
    del run
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
    for r in [one] + ranks:
        for name in MAIN_PATH_KERNELS:
            check(r["launches"][name] > 0,
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
    check(all(ranks_agree.values()), f"the ranks disagree: {ranks_agree}")
    check(all(e <= SCALE_OUT_RTOL for e in errors.values()),
          f"the gloo world differs from the unsharded run: {errors}")


def phase_dkg(torch) -> None:
    """One d-KG iteration through the driver at the main path's size:
    Branin with both partials observed (500 points x 3 channels, K's side
    1536 after the 16-point bucket), 16 members, q = 4, 200 multistarts,
    128 MC draws, float32.  Every launch counter is set to 0 just before
    and read just after: the three kernels' gates send derivative states to
    the plain path, so none may launch."""
    from cornell_moe_tpu_torch.bayes_opt import BayesianOptimizer
    from cornell_moe_tpu_torch.ops import kernels
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
    kernels.reset_launch_counts()
    t0 = time.time()
    rec = bo.run(num_iterations=1, num_init_pts=NUM_OBS)[-1]
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = kernels.launch_counts()
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
    for name in MAIN_PATH_KERNELS:
        check(counts[name] == 0, f"the d-KG path launched {name}")
    del states
    phase_chain_profile(torch, bo.model, "dkg_path")
    del bo
    torch.cuda.empty_cache()


def kernel_row(name, launches, err, times, plain, bound) -> dict:
    """One row of the kernels' summary line.  times, plain: the kernel's and
    its plain version's {"device_ms", "call_ms"} (:func:`_timed`); ms is the
    kernel's device time, and its share of the bound is bound / device_ms.
    bound: from :func:`_bound`.  No single PyTorch call computes any of
    these kernels' functions, so library_ms is null."""
    source, replaces = KERNELS[name]
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


def _bound(nbytes, fp32=0.0, matmul=0.0, mufu=0.0) -> dict:
    """The least time the card could take for a piece of work: the largest
    of the times its pipes need, since they run at once.  fp32: float32
    operations outside the tensor cores, at the FP32 peak; matmul: FLOP of
    matrix products, which reach float32 accuracy on the tensor cores as
    3xTF32 (three TF32 products each), at the TF32 peak; mufu: special-
    function operations (sqrt, exp); nbytes: each input read once, each
    output written once, at the HBM rate.  Returns {"ms", "by" ("bytes" or
    "operations"), "pipe", "pipes_ms"}."""
    pipes = {"fp32": fp32 / FP32_FLOPS * 1e3,
             "tf32x3": 3 * matmul / TF32_FLOPS * 1e3,
             "mufu": mufu / MUFU_OPS * 1e3,
             "hbm": nbytes / HBM_BYTES * 1e3}
    pipe = max(pipes, key=pipes.get)
    return {"ms": pipes[pipe], "by": "bytes" if pipe == "hbm" else
            "operations", "pipe": pipe, "pipes_ms": pipes}


def _mufu_per_field(kernel_name):
    """Special-function operations per field value: the Matern field's
    sqrt and exp, the squared exponential's exp."""
    return 2 if kernel_name == "matern_2.5" else 1


def descent_bound(s, b, m, np_, d, q, kernel_name, evaluations,
                  direction_out=False):
    """A (or D, evaluations = 1), over s b m np_ evaluations (draw, training
    point) pairs: per pair 3d FP32 FLOP of distance and 6 of the field, the
    field's MUFU operations, and 2 Wr FLOP of the moment contraction (a
    matrix product); bytes of xs0, ws, wt, beta, z, us, geom in and the
    points (or directions) out."""
    wr = (1 + q) * (1 + d)
    pairs = s * b * m * np_ * evaluations
    floats = 2 * s * b * d * m + s * d * np_ + s * b * wr * np_ + \
        s * b * q * m + q * m + s * b * q * d + \
        (0 if direction_out else 3 * s * d)
    return _bound(4 * floats, fp32=pairs * (3 * d + 6), matmul=pairs * 2 * wr,
                  mufu=pairs * _mufu_per_field(kernel_name))


def covariance_bound(s, n, d, kernel_name):
    """C: per element 3d FP32 FLOP of distance, 8 of the field, 1 for the
    amplitude, and the field's MUFU operations; the (S, n, n) output
    dominates the bytes."""
    return _bound(4 * (s * n * n + n * d + s * (1 + d) + s * n),
                  fp32=s * n * n * (3 * d + 9),
                  mufu=s * n * n * _mufu_per_field(kernel_name))


def lml_bound(w, np_, d, kernel_name):
    """B, per walker: the K build (Np^2 (3d + 9) FP32 FLOP and the field's
    MUFU operations), the Cholesky factorization (Np^3 / 3 FLOP, its
    trailing updates matrix products; Np square roots), forward
    substitution (Np^2 FLOP); us, alpha, noise, y in and two values out."""
    return _bound(4 * (w * d * np_ + w + 2 * w * np_ + 2 * w),
                  fp32=w * np_ * np_ * (3 * d + 10), matmul=w * np_ ** 3 / 3,
                  mufu=w * (np_ * np_ * _mufu_per_field(kernel_name) + np_))


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
    torch.profiler, read as phase_chain_profile reads them.  The wrapper's
    host work is left out, and a plain version's many small launches are
    summed.

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


def phase_equivalence(torch, model, counts):
    """Each kernel of the main path against its plain version on the card,
    in float32, at the main path's shapes.  Returns the kernels' summary
    rows and the descent problems, [(label, problem)]."""
    from cornell_moe_tpu_torch.ops import kernels
    from cornell_moe_tpu_torch.ops.domains import TensorProductDomain

    dev = model.device
    g = torch.Generator(device=dev).manual_seed(1234)
    states = model.models
    x, y, pn = model._padded_data()
    rows = []

    def row(name, err, times, plain, bound):
        rows.append(kernel_row(name, counts[name], err, times, plain, bound))

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
        covariance_bound(h.shape[0], x.shape[0], x.shape[1],
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
    np_main = x.shape[0]
    smem = kernels._lib().cmoe_lml_fused_cluster_smem_bytes(np_main)
    occupancy = {f"W{nw}_C{c}": kernels.lml_cluster_occupancy(nw, np_main, c)
                 for nw in (w // 2, w) for c in (kernels.LML_CLUSTER, 16)}
    emit({"phase": "lml_fused_cluster", "Np": np_main,
          "cluster": kernels.LML_CLUSTER,
          "smem_bytes_per_cta": smem,
          "smem_bytes_per_cta_C16": kernels.lml_cluster_smem_bytes(np_main,
                                                                    16),
          "capacity_np": kernels.LML_CLUSTER_CAPACITY,
          "max_active_clusters": occupancy})
    check(smem == kernels.lml_cluster_smem_bytes(np_main),
          "the kernel's shared-memory layout differs from the wrapper's")
    # the model's log-posterior at the chain's walkers, on the bench's
    # retrain problem (bench.py:297-315) and at the main path's walkers.
    # Against the float64 plain path, the kernel must be finite wherever
    # float64 is, and its largest relative deviation must be within 5e-3 or
    # no larger than the float32 plain path's own (at walkers whose K is too
    # ill-conditioned for float32 either way).
    for label, m in (("bench_retrain_problem", bench_retrain_model(torch)),
                     ("main_path_walkers", model)):
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
            and dev_k[fin].max().item() <= max(5e-3,
                                               dev_p[fin].max().item())
        both = torch.isfinite(lp_k) & torch.isfinite(lp_p)
        emit({"phase": "equivalence", "check": "log_posterior",
              "walkers_from": label, "walkers": int(m.p0.shape[0]),
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
    row("lml_fused", max(lml_errs), times[w // 2]["cluster"],
        times[w // 2]["plain"], lml_bound(w // 2, x.shape[0], d,
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
            kernels.reset_launch_counts()
            x = optimizers.gradient_ascent_batch(bvg, pb["dom"], pb["x0"],
                                                 params)
            torch.cuda.synchronize()
            counts = kernels.launch_counts()
            expected = params.max_num_steps * max(params.max_num_restarts, 1)
            route = x.double() / pb["width"]
            k_a, p32e, p64e = pb["endpoints"][params_label]
            r64 = _quantiles(torch, (route - p64e).abs())
            pp64 = _quantiles(torch, (p32e - p64e).abs())
            launched_ok = counts["descent_grad"] == expected > 0 and \
                all(c == 0 for n, c in counts.items() if n != "descent_grad")
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
                launches[n] += counts[n]
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


def phase_chain_profile(torch, model, path="main_path") -> None:
    """Where a stretch-move step of a path's chain spends its time: host
    wall clock per step (32 steps after 8 warm-up steps) against the
    device's busy time per step (the sum of its kernel and copy events in
    32 more steps under torch.profiler, whose own host cost shows in the
    profiled wall clock and not on the device)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from cornell_moe_tpu_torch.models import mcmc

    x, y, pn = model._padded_data()

    def log_prob(t):
        return model.log_posterior(t, x, y, pn)

    gen = torch.Generator(device=model.device).manual_seed(7)
    state = [model.p0, log_prob(model.p0)]
    steps = 32

    def run(n):
        torch.cuda.synchronize()
        t0 = time.time()
        for _ in range(n):
            state[:] = mcmc.stretch_move_step(gen, *state, log_prob)
        torch.cuda.synchronize()
        return (time.time() - t0) * 1e3 / n

    run(8)
    wall = run(steps)
    for attempt in range(1, DEVICE_MS_ATTEMPTS + 1):
        # the profiler may record no device event in a whole run
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            profiled_wall = run(steps)
        by_name, launches = {}, 0
        for ev in prof.events():
            if ev.device_type == DeviceType.CUDA:
                launches += 1
                by_name[ev.name] = by_name.get(ev.name, 0.0) + \
                    ev.time_range.elapsed_us() / 1e3 / steps
        if by_name:
            break
        emit({"phase": "device_ms_miscount", "attempt": attempt,
              "path": path, "device_events": 0})
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
    emit({"phase": "chain_profile", "path": path,
          "walkers": int(state[0].shape[0]),
          "steps": steps, "wall_ms_per_step": wall,
          "profiled_wall_ms_per_step": profiled_wall,
          "device_busy_ms_per_step": busy,
          "device_idle_share": 1.0 - busy / wall,
          "device_ops_per_step": launches / steps,
          "top_device_ms_per_step": {k[:48]: v for k, v in top}})
    check(busy > 0.0, "the profiler saw no device time in the chain")


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


def phase_cfkg(torch):
    """One cf-KG iteration through the driver at the main path's size:
    BraninFidelity (d = 3, the last coordinate a fidelity in [0.05, 1]),
    500 observations (512 after the bucket), 16 members, q = 4, 200
    multistarts, 128 MC draws, float32 (the settings of
    benchmarks/sample_efficiency_r04.py:117-121).  Every launch counter is
    set to 0 just before and read just after: kernel A's gate takes no
    fidelity dim, as the JAX package's does, so A may not launch, while B
    (the chain) and C (the fits) must.  Returns the optimizer."""
    import numpy as np
    from cornell_moe_tpu_torch.bayes_opt import BayesianOptimizer
    from cornell_moe_tpu_torch.ops import kernels
    from cornell_moe_tpu_torch.utils.synthetic_functions import \
        BraninFidelity

    bo = BayesianOptimizer(objective_func=BraninFidelity(), method="KG",
                           num_to_sample=Q, n_hypers=N_HYPERS, noisy=True,
                           standardize=True, device=DEVICE,
                           dtype=torch.float32, verbose=False)
    check(bo.num_fidelity == 1 and bo.dim == 3 and
          bo.sgd_params.num_multistarts == MULTISTARTS and
          bo.num_mc == NUM_MC, "cf-KG size changed")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.time()
    rec = bo.run(num_iterations=1, num_init_pts=NUM_OBS)[-1]
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = kernels.launch_counts()
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
          "capital": rec["capital"],
          "max_memory_allocated": torch.cuda.max_memory_allocated(),
          "launches": counts})
    check(counts["descent_run"] == 0 and counts["descent_run_fma"] == 0,
          "the cf-KG path launched kernel A")
    check(counts["lml_fused"] > 0 and counts["covariance_with_noise"] > 0,
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
    fields, ok, call, plain = _covariance_case(torch, x, h, nv, kernel_name)
    emit({"phase": "equivalence", "path": path, "kernel_name": kernel_name,
          **fields, "times": _timed(torch, call, 20),
          "plain": _timed(torch, plain, 20), "timing": TIMING.format(20),
          "bound_ms": covariance_bound(h.shape[0], x.shape[0], x.shape[1],
                                       kernel_name)["ms"]})
    check(ok, f"covariance_with_noise disagrees at the {path} shape "
              f"{fields['shape']}")


def phase_cfkg_equivalence(torch, bo) -> None:
    """Kernels B and C against their plain versions at the cf-KG path's
    shapes (d = 3), by phase_equivalence's rules at d = 2: C on the path's
    ensemble (S 16, n 512); B (cluster instance, W = 8 and 16, Np 512) with
    walker lengths drawn as there, against the plain version at rtol 5e-4
    and the large-Np instance at rtol 1e-6.  Each is timed as the kernels'
    summary times the main path's (device and call time, 20 calls)."""
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
              "bound_ms": lml_bound(nw, np_, d, model.kernel_name)["ms"],
              "tolerance": "rtol 5e-4 vs plain, rtol 1e-6 vs the large-Np "
                           "instance", "ok": ok})
        check(ok, f"lml_fused disagrees at the cf-KG path's W={nw}, d={d}")


LCB_MEAN_RTOL = 1e-3      # of max(1, max |mu64|), as phase_small_reference
LCB_VARIANCE_RTOL = 1e-4  # of the member's signal variance alpha


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
    from cornell_moe_tpu_torch.ops import kernels

    member = states.member(0)
    dom = kg_domain(member.points_sampled.device, torch.float32)
    cand = dom.generate_uniform_random_points_in_domain(
        torch.Generator(device=dom.bounds.device).manual_seed(99),
        LCB_CANDIDATES)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.time()
    picks, _ = lcb.lower_confidence_bound_optimization(member, cand, Q)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = kernels.launch_counts()

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
    check(counts["covariance_with_noise"] == Q - 1,
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


def phase_pes(torch) -> None:
    """One iteration of ``pes_driver.run_PES`` on Hartmann6 at the
    reference scale of benchmarks/bench_suite.py:246-336: 60 initial
    points, M = 100 hyperparameter sets, burn-in 50, 1000 random features,
    grid 500, float32 on the card, artifacts in a temporary directory.  Each
    part is timed by the driver's PhaseTimer; C's launches are counted (the
    port's gate has no size window, so the M-set SE fits at n = 60 and 61,
    d = 6 launch it).  Then C against its plain version on those fits' own
    inputs: the artifacts' first 60 and all 61 points, and the sets the
    driver's ``sample_hypers`` draws there from the run's seed (the run's
    draws replayed: its initial design, then the chain)."""
    import tempfile

    import numpy as np
    from cornell_moe_tpu_torch.acquisition import pes_driver
    from cornell_moe_tpu_torch.models.covariance import SquareExponential
    from cornell_moe_tpu_torch.ops import kernels
    from cornell_moe_tpu_torch.ops.domains import TensorProductDomain
    from cornell_moe_tpu_torch.utils.logging_utils import PhaseTimer
    from cornell_moe_tpu_torch.utils.synthetic_functions import Hartmann6

    f = Hartmann6()
    timer = PhaseTimer()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    with tempfile.TemporaryDirectory() as out_dir:
        t0 = time.time()
        hist = pes_driver.run_PES(
            lambda p: float(f.evaluate_true(p)[0]), [0.0] * 6, [1.0] * 6, 6,
            number_of_hyperparameter_sets=PES_SETS,
            number_of_burnin=PES_BURNIN, number_of_initial_points=PES_INIT,
            number_of_iterations=1, gridsize=PES_GRID, seed=0,
            output_dir=out_dir, verbose=False, device=DEVICE,
            dtype=torch.float32, timer=timer)
        torch.cuda.synchronize()
        wall = time.time() - t0
        counts = kernels.launch_counts()
        art = {name: np.loadtxt(os.path.join(out_dir, name), ndmin=2)
               for name in ("Xsamples.txt", "Ysamples.txt", "guesses.txt")}
    rows = {name: a.shape[0] for name, a in art.items()}
    finite_sets = [r["finite_sets"] for r in timer.records
                   if r["phase"] == "x_star_draws_and_ep"][0]
    h = hist[-1]
    emit({"phase": "pes_path", "seconds": wall,
          "parts": {r["phase"]: r["seconds"] for r in timer.records},
          "initial_points": PES_INIT, "sets": PES_SETS,
          "finite_sets": finite_sets,
          "suggested": h["suggested"].tolist(),
          "value": h["value"], "recommended": h["recommended"].tolist(),
          "best_so_far": h["best_so_far"], "artifact_rows": rows,
          "max_memory_allocated": torch.cuda.max_memory_allocated(),
          "launches": counts})
    check(finite_sets >= 1, "no PES hyperparameter set came out finite")
    check(counts["covariance_with_noise"] > 0,
          "the PES path's fits did not launch kernel C")
    for name in ("suggested", "recommended"):
        v = np.asarray(h[name])
        check(bool(np.isfinite(v).all() and (v >= 0.0).all() and
                   (v <= 1.0).all()), f"PES {name} point {v} not finite in "
                                      "[0, 1]^6")
    check(rows == {"Xsamples.txt": PES_INIT + 1,
                   "Ysamples.txt": PES_INIT + 1,
                   "guesses.txt": PES_INIT + 1},
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
        vals, _ = kg.knowledge_gradient_batch(
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
        vals, _ = kg.knowledge_gradient_batch(
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
        out[dev], _ = kg.knowledge_gradient_mcmc_batch(
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
    recommendation launch neither A nor D.  Returns the optimizer."""
    import numpy as np
    from cornell_moe_tpu_torch.bayes_opt import BayesianOptimizer
    from cornell_moe_tpu_torch.ops import kernels
    from cornell_moe_tpu_torch.utils.synthetic_functions import Branin

    bo = BayesianOptimizer(objective_func=Branin(), method="EI",
                           num_to_sample=Q, n_hypers=N_HYPERS, noisy=True,
                           standardize=True, device=DEVICE,
                           dtype=torch.float32, verbose=False)
    check(bo.sgd_params.num_multistarts == MULTISTARTS and
          bo.num_mc == EI_NUM_MC, "EI path size changed")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.time()
    rec = bo.run(num_iterations=1, num_init_pts=NUM_OBS)[-1]
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = kernels.launch_counts()
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
          "max_memory_allocated": torch.cuda.max_memory_allocated(),
          "launches": counts})
    check(math.isfinite(rec["voi"]) and rec["voi"] >= 0.0,
          f"EI VOI {rec['voi']} not finite and >= 0")
    check(sugg.shape == (Q, 2) and _domain_check(sugg, bounds),
          f"EI suggestions {sugg} not q points inside the domain")
    check(_domain_check(r, bounds) and math.isfinite(rec["true_value"]),
          f"EI recommendation {r} not finite inside the domain")
    for name in ("descent_run", "descent_run_fma", "descent_grad",
                 "descent_grad_fma"):
        check(counts[name] == 0, f"the EI path launched {name}")
    check(counts["lml_fused"] > 0 and counts["covariance_with_noise"] > 0,
          "the EI path did not launch kernels B and C")
    check(bool(torch.isfinite(states.chol_K).all()),
          "an EI ensemble member's chol_K is non-finite")
    return bo


def phase_heuristic_ei(torch, bo) -> None:
    """Heuristic q-EI (q = 4) on member 0 of the EI path's ensemble, under
    the kriging believer and under the constant liar (the lie: the best
    observed value), with the driver's multistart parameters.  Each
    policy refits one GP at n0 + q = 516 points five times (kernel C at
    S 1, n 516, d 2); C's launches and their shapes are recorded.  Then C
    against its plain version on the last refit's own inputs."""
    import functools

    from cornell_moe_tpu_torch.acquisition import expected_improvement as ei
    from cornell_moe_tpu_torch.ops import kernels

    member = bo.model.models.member(0)
    bounds = bo.objective_func._search_domain
    shapes, last = {}, {}
    covariance = kernels.covariance_with_noise

    def recording_covariance(points, hypers, noise, kernel_name):
        key = f"S{hypers.shape[0]}_n{points.shape[0]}_d{points.shape[1]}"
        shapes[key] = shapes.get(key, 0) + 1
        last["args"] = (points, hypers, noise, kernel_name)
        return covariance(points, hypers, noise, kernel_name)

    policies = {
        "kriging_believer": None,
        "constant_liar": functools.partial(
            ei.constant_liar_estimate,
            lie_value=float(member.best_observed_value))}
    picks, seconds = {}, {}
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    kernels.covariance_with_noise = recording_covariance
    try:
        for name, policy in policies.items():
            t0 = time.time()
            pts = ei.heuristic_expected_improvement_optimization(
                bo.generator, member, bo.domain, Q, bo.sgd_params,
                estimation_policy=policy, num_mc_iterations=bo.num_mc)
            torch.cuda.synchronize()
            seconds[name] = time.time() - t0
            picks[name] = pts.cpu().numpy()
    finally:
        kernels.covariance_with_noise = covariance
    counts = kernels.launch_counts()
    n_refit = member.num_sampled + Q
    emit({"phase": "heuristic_ei", "q": Q, "seconds": seconds,
          "picks": {k: v.tolist() for k, v in picks.items()},
          "refit_n": n_refit, "covariance_launches_by_shape": shapes,
          "launches": counts})
    for name, pts in picks.items():
        check(pts.shape == (Q, 2) and _domain_check(pts, bounds),
              f"heuristic q-EI ({name}) picks {pts} outside the domain")
    check(n_refit == 516 and shapes == {f"S1_n{n_refit}_d2": 2 * (1 + Q)},
          f"heuristic q-EI refits {shapes}, expected 10 at S1_n516_d2")
    check(counts["covariance_with_noise"] == 2 * (1 + Q),
          "the heuristic refits did not launch kernel C")
    x, h, nv, kernel_name = last["args"]
    _covariance_line(torch, "heuristic_ei", x, h, nv, kernel_name)


def phase_map(torch, bo) -> None:
    """The MAP fit, ``optimize(num_restarts=4)``, on the EI path's model:
    a damped Newton from each of 4 prior draws over the plain log
    posterior.  Kernel B has no backward, so the fit may not launch it;
    its counter is set to 0 just before and read just after.  The chosen
    point (the best finite end, else the best start) is held against the
    best start."""
    from cornell_moe_tpu_torch.ops import kernels

    model = bo.model
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.time()
    model.optimize(num_restarts=MAP_RESTARTS)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = kernels.launch_counts()
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
          "chosen_from": "end" if bool(finite.any()) else "start",
          "hypers": model.hypers.tolist(), "launches": counts})
    check(counts["lml_fused"] == 0 and counts["lml_fused_global"] == 0,
          "the MAP fit launched kernel B")
    check(chosen >= best_start,
          f"MAP point {chosen} below the best start {best_start}")
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
        driver(path).run(1, num_init_pts=CKPT_OBS)
        resumed = driver(path)
        meta = resumed.resume()
        got = resumed.run(2, start_iteration=1)[-1]
    torch.cuda.synchronize()
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
                         best_so_far=None, num_mc_iterations=None):
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
    phase_scale_out(torch, bo, rec)
    phase_dkg(torch)
    summary, problems = phase_equivalence(torch, bo.model, counts)
    summary += phase_descent_grad(torch, bo.model.kernel_name, problems)
    phase_chain_profile(torch, bo.model)
    phase_lcb(torch, bo.model.models)
    del problems
    cf = phase_cfkg(torch)
    phase_cfkg_equivalence(torch, cf)
    del cf
    torch.cuda.empty_cache()
    phase_pes(torch)
    ei_bo = phase_ei(torch)
    phase_heuristic_ei(torch, ei_bo)
    phase_map(torch, ei_bo)
    del ei_bo
    torch.cuda.empty_cache()
    phase_checkpoint_resume(torch)
    phase_cli(torch)
    phase_small_reference(torch)
    phase_small_reference_ei(torch)
    check("jax" not in sys.modules and "cornell_moe_tpu" not in sys.modules,
          "the port imported JAX or the JAX package")
    emit({"kernels": summary})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
