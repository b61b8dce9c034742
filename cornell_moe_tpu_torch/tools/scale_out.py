"""The main path's iteration sharded over the cards of one host, held to
the unsharded iteration.

    torchrun --nproc_per_node=N -m cornell_moe_tpu_torch.tools.scale_out

Every rank (NCCL, rank r on ``cuda:r``) runs one iteration of
``BayesianOptimizer(n_devices=N)`` at the main path's size (Branin, 500
observations, 16 members, q = 4, 200 multistarts, 128 MC draws, float32),
its launch counters set to 0 just before and read just after, then times
the collective of the chain's half-step.  Rank 0 then runs the unsharded
iteration with the same chunking (``suggest_chunk_size`` 200 / N) and
prints one JSON line: each rank's stage times, launches and kernel calls
by shape, whether the ranks and the unsharded run agree bit for bit, and
the largest differences.  Exits 1 when they do not agree, 2 without a card
or outside ``torchrun``.

:func:`iteration` and the comparisons are also ``chip_smoke.py``'s, which
drives the same iteration on one card.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

# the main path's size
NUM_OBS = 500
MAIN_PATH = dict(method="KG", num_to_sample=4, n_hypers=16, noisy=True,
                 standardize=True, dtype=torch.float32, verbose=False)

SUMMARY_KEYS = ("walkers", "hypers", "suggested", "voi", "recommended",
                "true_value", "chain_steps")


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def iteration(device, descent=None, num_obs: int = NUM_OBS, **bo_kwargs):
    """One BO iteration through the driver at the main path's settings
    (``bo_kwargs`` override them) on ``device``, with kernel A's launches
    sent to ``descent`` (a wrapper of ``ops.kernels``; ``descent_run`` when
    None) and every launch counter set to 0 just before and read just
    after.  Returns the optimizer, the iteration's record, its wall time,
    the counts, A's launches by shape and schedule (S, B, M, steps x
    restarts) and B's calls by shape (W walkers, Np)."""
    from cornell_moe_tpu_torch.bayes_opt import BayesianOptimizer
    from cornell_moe_tpu_torch.ops import kernels
    from cornell_moe_tpu_torch.utils.synthetic_functions import Branin

    bo = BayesianOptimizer(**dict(MAIN_PATH, objective_func=Branin(),
                                  device=device, **bo_kwargs))
    shapes, lml_shapes = {}, {}
    descent_run, lml_fused = kernels.descent_run, kernels.lml_fused
    descent = descent or descent_run

    def recording_descent(xs0, *args, steps, restarts, **kw):
        key = "S{}_B{}_M{}_steps{}".format(xs0.shape[0], xs0.shape[1],
                                           xs0.shape[3], steps * restarts)
        shapes[key] = shapes.get(key, 0) + 1
        return descent(xs0, *args, steps=steps, restarts=restarts, **kw)

    def recording_lml(us, *args, **kw):
        key = "W{}_Np{}".format(us.shape[0], us.shape[2])
        lml_shapes[key] = lml_shapes.get(key, 0) + 1
        return lml_fused(us, *args, **kw)

    _sync(device)
    kernels.reset_launch_counts()
    kernels.descent_run = recording_descent
    kernels.lml_fused = recording_lml
    try:
        t0 = time.time()
        history = bo.run(num_iterations=1, num_init_pts=num_obs)
        _sync(device)
        wall = time.time() - t0
    finally:
        kernels.descent_run = descent_run
        kernels.lml_fused = lml_fused
    return (bo, history[-1], wall, kernels.launch_counts(), shapes,
            lml_shapes)


def summary(bo, rec, wall, counts, shapes, lml_shapes) -> dict:
    """What a comparison keeps of one :func:`iteration`, as host data:
    stage times, the walkers after the last chain, the samples and the
    record."""
    return {"seconds": wall,
            "stages": {r["phase"]: r["seconds"] for r in bo.timer.records},
            "suggest_chunk_size": bo.suggest_chunk_size,
            "chain_steps": list(bo.model.chain_steps),
            "walkers": bo.model.p0.cpu().numpy(),
            "hypers": np.asarray(bo.model.hypers),
            "suggested": rec["suggested"], "voi": rec["voi"],
            "recommended": rec["recommended"],
            "true_value": rec["true_value"], "launches": counts,
            "descent_run_launches_by_shape": shapes,
            "lml_fused_calls_by_shape": lml_shapes}


def bitwise(a: dict, b: dict) -> dict:
    """Per quantity of two summaries: equal bit for bit."""
    return {k: bool(np.array_equal(np.asarray(a[k]), np.asarray(b[k])))
            for k in SUMMARY_KEYS}


def errors_over_scale(got: dict, ref: dict, width) -> dict:
    """Largest differences of ``got`` from ``ref``, each over its scale:
    walkers over max(1, |walker|) (log space), suggested and recommended
    points over the domain's ``width``, the VOI over |VOI|."""
    def rel(k, scale):
        return float(np.max(np.abs(np.asarray(got[k]) - np.asarray(ref[k]))
                            / scale))

    return {"walkers": rel("walkers",
                           np.maximum(1.0, np.abs(ref["walkers"]))),
            "suggested": rel("suggested", width),
            "recommended": rel("recommended", width),
            "voi": rel("voi", abs(ref["voi"]))}


def printable(summary_: dict) -> dict:
    """A summary for a JSON line: arrays as lists, walkers and hypers
    left out."""
    return {k: v.tolist() if hasattr(v, "tolist") else v
            for k, v in summary_.items() if k not in ("walkers", "hypers")}


def gather_ms(group, device, walkers: int, reps: int = 200) -> float:
    """Host wall time of one ``all_gather_rows`` of a chain half-step's
    log-posteriors (this rank's block of ``walkers``, float32 on
    ``device``): the mean over ``reps`` calls after a warm-up,
    synchronized."""
    import torch.distributed as dist

    from cornell_moe_tpu_torch.parallel import sharding
    block = torch.zeros(walkers // dist.get_world_size(group), device=device,
                        dtype=torch.float32)
    for _ in range(10):
        sharding.all_gather_rows(block, group)
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        sharding.all_gather_rows(block, group)
    _sync(device)
    return (time.perf_counter() - t0) / reps * 1e3


def main() -> int:
    import torch.distributed as dist

    from cornell_moe_tpu_torch import config
    from cornell_moe_tpu_torch.bayes_opt import DEFAULT_SGD_PARAMS_KG
    from cornell_moe_tpu_torch.parallel import sharding
    from cornell_moe_tpu_torch.utils.synthetic_functions import Branin

    if not torch.cuda.is_available() or "WORLD_SIZE" not in os.environ:
        print("scale_out: run on a machine with CUDA cards under "
              "torchrun --nproc_per_node=N", file=sys.stderr)
        return 2
    world = int(os.environ["WORLD_SIZE"])
    group = sharding.default_process_group(world)
    device = config.default_device()
    mine = summary(*iteration(device, n_devices=world))
    mine.update(rank=dist.get_rank(), device=str(device),
                card=torch.cuda.get_device_name(device),
                backend=str(dist.get_backend(group)),
                all_gather_ms=gather_ms(group, device,
                                        MAIN_PATH["n_hypers"] // 2))
    ranks = [None] * world
    dist.all_gather_object(ranks, mine, group=group)
    ok = True
    if dist.get_rank() == 0:
        ref = summary(*iteration(
            device, suggest_chunk_size=DEFAULT_SGD_PARAMS_KG.num_multistarts
            // world))
        agree = [bitwise(r, ranks[0]) for r in ranks]
        to_ref = bitwise(ranks[0], ref)
        ok = all(all(a.values()) for a in agree) and all(to_ref.values())
        print(json.dumps({
            "phase": "scale_out_cards", "world": world,
            "ranks": [printable(r) for r in ranks],
            "ranks_bitwise_equal": agree, "unsharded": printable(ref),
            "bitwise_equal_to_unsharded": to_ref,
            "max_err_over_scale": errors_over_scale(
                ranks[0], ref, np.ptp(Branin()._search_domain, axis=1)),
            "ok": ok}), flush=True)
    ok = sharding.broadcast_from_rank0(ok, group)
    dist.destroy_process_group()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
