"""Scale-out over ``torch.distributed``: the restart axis of the
multistarts, the walkers of the MCMC chain and the points of a point list,
sharded across the ranks of a process group.

Counterpart of ``cornell_moe_tpu/parallel/sharding.py``.  The JAX module is
single-controller: one process, a device mesh, ``jax.shard_map``.  Here the
same work is SPMD, one process per card:

* every rank runs the same program from the same seed, so its starts,
  normals and stretch moves are identical to every other rank's (one
  ``torch.Generator`` per rank, seeded alike): the JAX module's determinism
  argument, with the rank's generator in place of ``fold_in``;
* each rank computes its block of the sharded axis, edge-padded to a
  multiple of the world size (:func:`pad_to_multiple`);
* one ``all_gather`` rebuilds the full axis on every rank.  It moves only
  (points, values) per start, or the log-posterior per walker.

Every rank holds the whole GP ensemble, so nothing is placed: the JAX
module's ``shard_ensemble_states`` has no counterpart.  A ``group`` of None
runs the unsharded function, so callers pass their optional group through.

A gloo group gathers host tensors, so a CUDA block is copied to the host
for the collective alone (:func:`all_gather_rows`); the computation stays
on the card.  Under NCCL the gather stays on the card, into one
preallocated tensor, so the programs of ``ops.programs`` capture it with
the work around it (:func:`group_captures`): every rank builds the same
programs in the same order, from the same schedule and seed, which keeps
the captured collectives matched across the ranks.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import torch
import torch.distributed as dist

from cornell_moe_tpu_torch.ops import optimizers


def default_process_group(n_devices: Optional[int] = None, device=None):
    """The process group of a run over ``n_devices`` ranks.

    The default group when ``torch.distributed`` is initialized.  Otherwise
    one initialized from the ``torchrun`` environment (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``): NCCL,
    with the current CUDA device set to ``cuda:LOCAL_RANK``, or gloo when
    ``device`` is the CPU.  Outside ``torchrun`` only a world of one is
    made (``n_devices`` 1, an in-process store); more ranks raise
    ``RuntimeError`` with the launch command.  Raises ``ValueError`` when
    the world size is not ``n_devices``."""
    if not dist.is_initialized():
        on_cpu = device is not None and torch.device(device).type == "cpu"
        backend = "gloo" if on_cpu else "nccl"
        if "WORLD_SIZE" in os.environ:
            if not on_cpu:
                torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
            dist.init_process_group(backend, init_method="env://")
        elif n_devices == 1:
            dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                    world_size=1)
        else:
            raise RuntimeError(
                f"{n_devices} devices take one process each: launch with "
                f"torchrun --nproc_per_node={n_devices}")
    world = dist.get_world_size()
    if n_devices is not None and world != n_devices:
        raise ValueError(f"the process group has {world} ranks, not "
                         f"n_devices={n_devices}")
    return dist.group.WORLD


def pad_to_multiple(x: torch.Tensor, multiple: int, axis: int = 0):
    """Pad a batch axis so it divides the world (edge mode: copies of the
    last entry); returns (padded, n_valid)."""
    n = x.shape[axis]
    rem = (-n) % multiple
    if rem == 0:
        return x, n
    reps = [1] * x.dim()
    reps[axis] = rem
    return torch.cat([x, x.narrow(axis, n - 1, 1).repeat(reps)],
                     dim=axis), n


def _local_block(x: torch.Tensor, group):
    """This rank's rows [r s, (r + 1) s) of ``x`` padded to a multiple of
    the world size, as a fresh tensor; returns (block, n_valid)."""
    size = dist.get_world_size(group)
    padded, n_valid = pad_to_multiple(x, size)
    s = padded.shape[0] // size
    r = dist.get_rank(group)
    return padded[r * s:(r + 1) * s].clone(), n_valid


def group_captures(group, device) -> bool:
    """Whether a program (``ops.programs``) may hold this group's
    collectives on ``device``: True without a group, on the CPU (where a
    program calls its function directly) and for an NCCL group, whose
    collectives a CUDA graph captures; False for a gloo group on a CUDA
    device, whose collectives run on the host."""
    if group is None or torch.device(device).type != "cuda":
        return True
    return dist.get_backend(group) == dist.Backend.NCCL


def all_gather_rows(block: torch.Tensor, group) -> torch.Tensor:
    """Every rank's block (equal shapes) concatenated along axis 0, in rank
    order, on the block's device.  NCCL gathers into one preallocated
    tensor on the card (a CUDA graph can hold it); gloo takes host tensors:
    a CUDA block is copied to the host for the collective and the result
    back."""
    staged = block.contiguous()
    world = dist.get_world_size(group)
    if dist.get_backend(group) == dist.Backend.NCCL:
        out = torch.empty((world * staged.shape[0],) + staged.shape[1:],
                          dtype=staged.dtype, device=staged.device)
        dist.all_gather_into_tensor(out, staged, group=group)
        return out
    if staged.is_cuda:
        staged = staged.cpu()
    parts = [torch.empty_like(staged) for _ in range(world)]
    dist.all_gather(parts, staged, group=group)
    return torch.cat(parts).to(block.device)


def group_key(group):
    """The part of a program's key that tells groups apart: (world size,
    rank), or None without a group, so that two groups never share a
    captured collective."""
    if group is None:
        return None
    return dist.get_world_size(group), dist.get_rank(group)


def broadcast_from_rank0(obj, group):
    """Rank 0's ``obj`` (any picklable value) on every rank."""
    box = [obj]
    src = 0 if group is dist.group.WORLD else dist.get_global_rank(group, 0)
    dist.broadcast_object_list(box, src=src, group=group)
    return box[0]


def _sharded_multistart(run_block: Callable, initial_points: torch.Tensor,
                        group) -> optimizers.MultistartResult:
    """``run_block`` (a multistart over a block of starts) on this rank's
    block; one gather of every start's (endpoint, value), trimmed to the
    real starts, then the finite-safe argmax."""
    if group is None:
        return run_block(initial_points)
    block, n_valid = _local_block(initial_points, group)
    res = run_block(block)
    packed = torch.cat([res.all_points.reshape(block.shape[0], -1),
                        res.all_values[:, None]], dim=1)
    packed = all_gather_rows(packed, group)[:n_valid]
    return optimizers.select_best(
        packed[:, :-1].reshape((n_valid,) + block.shape[1:]), packed[:, -1])


def sharded_multistart_optimize(
        value_and_grad_fn: Callable, domain, initial_points: torch.Tensor,
        params: optimizers.GradientDescentParameters, group,
        value_fn: Optional[Callable] = None,
        conv_tol: Optional[float] = None) -> optimizers.MultistartResult:
    """Per-start multistart GD with the restart axis sharded: each rank
    runs :func:`optimizers.multistart_optimize` on its block of starts.
    Each start's trajectory and ``conv_tol`` gate are its own, so the
    result is the unsharded call's."""
    return _sharded_multistart(
        lambda b: optimizers.multistart_optimize(value_and_grad_fn, domain,
                                                 b, params, value_fn,
                                                 conv_tol=conv_tol),
        initial_points, group)


def sharded_multistart_optimize_batched(
        batched_value_and_grad: Callable, domain,
        initial_points: torch.Tensor,
        params: optimizers.GradientDescentParameters, group
        ) -> optimizers.MultistartResult:
    """Sharded counterpart of :func:`optimizers.multistart_optimize_batched`
    (one chunk, no gate): each rank runs the lockstep-batched GD on its
    block; the batched objective's inner axes (members, draws, inner
    descents) stay on the rank.  Per-start math is independent, so results
    match the unsharded run."""
    return _sharded_multistart(
        lambda b: optimizers.multistart_optimize_batched(
            batched_value_and_grad, domain, b, params),
        initial_points, group)


def sharded_multistart_optimize_batched_gated(
        batched_value_and_grad: Callable, domain,
        initial_points: torch.Tensor,
        params: optimizers.GradientDescentParameters, group,
        chunk_size: Optional[int] = None,
        conv_tol: Optional[float] = None,
        step_fn: Optional[Callable] = None) -> optimizers.MultistartResult:
    """Batched multistart, sharded, with the per-chunk convergence gate
    (``step_fn`` as in :func:`optimizers.multistart_optimize_batched`).

    Each rank runs :func:`optimizers.multistart_optimize_batched`
    (chunking + the step-norm conv_tol gate, gpp_optimization.hpp:667-671
    semantics) on its shard of the restart axis.  Equivalence to a
    single-device run holds when ``chunk_size`` matches the chunking used
    there (defaults to one chunk per device shard) AND
    ``num_multistarts % n_devices == 0``: when starts don't divide the
    mesh, the trailing shard is edge-padded with duplicates of the last
    start (whose deterministic trajectories contribute step norms
    identical to the original's, so the duplicates themselves never move
    the gate's max) but the shard *grouping* of the gate's max-reduction
    no longer matches any single-device chunking, so per-start results
    may differ within conv_tol-sized slack (ADVICE r4).
    """
    return _sharded_multistart(
        lambda b: optimizers.multistart_optimize_batched(
            batched_value_and_grad, domain, b, params,
            chunk_size=chunk_size, conv_tol=conv_tol, step_fn=step_fn),
        initial_points, group)


def sharded_multistart_optimize_batched_warm(
        bvg_cold: Callable, bvg_warm: Callable, domain,
        initial_points: torch.Tensor,
        params: optimizers.GradientDescentParameters, group,
        chunk_size: Optional[int] = None,
        conv_tol: Optional[float] = None,
        warm_step: Optional[Callable] = None) -> optimizers.MultistartResult:
    """Sharded counterpart of
    :func:`optimizers.multistart_optimize_batched_warm` (``warm_step`` as
    there).

    The PRODUCTION suggest program (warm-started inner descents +
    optional convergence gate) scaled out over the restart axis: each
    device runs the warm chunked solver on its shard, so the inner-
    problem carry and the per-chunk step-norm gate stay device-local
    and the only collective is the final argmax gather.

    Exact sharded==single equivalence holds when ``chunk_size`` equals
    the per-device shard size (the gate's max-reduction then spans the
    same start groups in both programs); smaller chunk sizes divide each
    shard further and still match a single-device run using the same
    chunking.  Defaults to one chunk per device shard.  As in the gated
    variant, exactness additionally requires
    ``num_multistarts % n_devices == 0`` — otherwise the trailing shard
    is edge-padded (duplicate lanes contribute identical step norms, so
    they never move the gate's max, but the gate's start-grouping then
    matches no single-device chunking; divergence is bounded by the
    conv_tol slack) (ADVICE r4).
    """
    return _sharded_multistart(
        lambda b: optimizers.multistart_optimize_batched_warm(
            bvg_cold, bvg_warm, domain, b, params, chunk_size=chunk_size,
            conv_tol=conv_tol, warm_step=warm_step),
        initial_points, group)


def sharded_point_evaluation(value_fn: Callable, points: torch.Tensor,
                             group) -> torch.Tensor:
    """A batched ``value_fn`` ((P, ...) -> (P,)) over a point list, each
    rank evaluating its block; the values gathered on every rank."""
    if group is None:
        return value_fn(points)
    block, n_valid = _local_block(points, group)
    return all_gather_rows(value_fn(block), group)[:n_valid]


def sharded_ensemble_mcmc_step(log_prob_fn: Callable, group) -> Callable:
    """A stretch-move step ``step(generator, positions, log_probs)`` with
    each half-ensemble's log-posteriors computed in walker blocks, one per
    rank, and gathered.  The stretch moves are drawn on every rank from
    its own generator, seeded alike, so every rank holds the same
    ensemble."""
    from cornell_moe_tpu_torch.models.mcmc import stretch_move_step

    def sharded_lp(positions):
        return sharded_point_evaluation(log_prob_fn, positions, group)

    def step(generator, positions, log_probs):
        return stretch_move_step(generator, positions, log_probs, sharded_lp)

    return step
