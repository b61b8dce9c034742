"""Run one function on every rank of a process group spawned on this host.

``torchrun`` is the launcher of a run over several cards.  This helper
starts a group from inside a program instead (the tests' gloo groups on
the CPU, and ``chip_smoke.py``'s group of two ranks on one card): each rank
is a process of multiprocessing's spawn method that joins the group over a
``FileStore``, calls the function and reports its return value.
"""

from __future__ import annotations

import datetime
import queue
import time
import traceback
from typing import Callable, Sequence

import torch.distributed as dist
import torch.multiprocessing as mp

# seconds a rank is given to leave after it reported
_JOIN_S = 10.0
# seconds the other ranks' reports are awaited after a rank failed
_GRACE_S = 5.0


def _rank_main(fn, rank, world_size, backend, store_path, timeout_s, args,
               results):
    try:
        dist.init_process_group(
            backend, store=dist.FileStore(store_path, world_size),
            rank=rank, world_size=world_size,
            timeout=datetime.timedelta(seconds=timeout_s))
        try:
            out = fn(*args)
        finally:
            dist.destroy_process_group()
    except Exception:
        results.put((rank, False, traceback.format_exc()))
        raise
    results.put((rank, True, out))


def run_process_group(fn: Callable, world_size: int, store_path: str,
                      args: Sequence = (), backend: str = "gloo",
                      timeout_s: float = 300.0) -> list:
    """``fn(*args)`` on each of ``world_size`` spawned ranks, joined in one
    ``backend`` group over a ``FileStore`` at ``store_path`` (a file that
    does not exist yet); returns the ranks' return values in rank order.

    ``fn`` is pickled by its import path and its return value by value, so
    both must be picklable (return host data, not CUDA tensors).  A rank
    that raises fails the call with its traceback, and with those of the
    ranks that fail within ``_GRACE_S`` after it (a rank left waiting in a
    collective fails too); so does a rank that dies without a result, and
    the whole group when ``timeout_s`` passes first.  Every rank still
    running at the end is killed."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, rank, world_size, backend, store_path,
                               timeout_s, tuple(args), results))
             for rank in range(world_size)]
    for p in procs:
        p.start()
    out, failed = {}, {}
    deadline = time.monotonic() + timeout_s
    try:
        while len(out) + len(failed) < world_size:
            left = deadline - time.monotonic()
            if left <= 0:
                break
            try:
                rank, ok, value = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in out and r not in failed and
                        p.exitcode not in (None, 0)]
                for r in dead:
                    failed[r] = f"died without a result (exit code " \
                        f"{procs[r].exitcode})"
                    deadline = min(deadline, time.monotonic() + _GRACE_S)
                continue
            if ok:
                out[rank] = value
            else:
                failed[rank] = value
                deadline = min(deadline, time.monotonic() + _GRACE_S)
    finally:
        for p in procs:
            p.join(_JOIN_S if len(out) == world_size else 0.0)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
    if failed:
        raise RuntimeError("\n".join(
            f"rank {r} of {world_size} failed:\n{msg}"
            for r, msg in sorted(failed.items())))
    if len(out) < world_size:
        raise TimeoutError(
            f"ranks {sorted(set(range(world_size)) - set(out))} gave no "
            f"result within {timeout_s} s")
    return [out[r] for r in range(world_size)]
