"""Experiment driver command line.

Counterpart of ``examples/main.py``:

    python -m cornell_moe_tpu_torch.main <func> <KG|EI> <q> <job_id>
        [HeSBO|none] [eff_dim] [iters] [--device=cpu] [--devices=N]

e.g.  python -m cornell_moe_tpu_torch.main Branin EI 2 1 none 0 1
      python -m cornell_moe_tpu_torch.main Hartmann6 EI 1 1 HeSBO 2 1
      python -m cornell_moe_tpu_torch.main KISSGP KG 1 1 none 0 1
      torchrun --nproc_per_node=4 -m cornell_moe_tpu_torch.main \
          Branin KG 4 1 none 0 1 --devices=4

``<func>`` is a name of ``utils.synthetic_functions.SYNTHETIC_FUNCTIONS``,
or ``KISSGP`` or ``CIFAR10`` (``utils.real_functions``); ``HeSBO
<eff_dim>`` optimizes it in a count-sketch embedding of that dimension
(seeded by the job id); ``iters`` defaults to 10.  The run takes
``cuda:0`` unless ``--device=cpu`` is given.  ``--devices=N`` shards the
suggest, the chain and the recommendation over N ranks, one process per
card, launched by ``torchrun --nproc_per_node=N`` (each rank on
``cuda:LOCAL_RANK``); without ``torchrun`` only N = 1 runs, a world of
one.  The last line printed (by rank 0) is the best true value among the
iterations' recommendations.
"""

from __future__ import annotations

import os
import sys

import torch.distributed as dist

from cornell_moe_tpu_torch.bayes_opt import BayesianOptimizer
from cornell_moe_tpu_torch.utils import hesbo, real_functions
from cornell_moe_tpu_torch.utils.synthetic_functions import \
    SYNTHETIC_FUNCTIONS

REAL_FUNCTIONS = {"KISSGP": real_functions.KISSGP,
                  "CIFAR10": real_functions.CIFAR10}


def main(argv) -> int:
    """Run the command line ``argv`` (``sys.argv``: the program name
    first); returns the exit code."""
    argv = list(argv)
    device = n_devices = None
    for a in list(argv):
        if a.startswith("--devices"):
            if "=" not in a:
                print("--devices requires '=': use --devices=N")
                return 1
            n_devices = int(a.split("=", 1)[1])
            argv.remove(a)
        elif a.startswith("--device"):
            if "=" not in a:
                print("--device requires '=': use --device=cpu")
                return 1
            device = a.split("=", 1)[1]
            argv.remove(a)
    if len(argv) < 5:
        print(__doc__)
        return 1
    obj_func_name, method = argv[1], argv[2]
    num_to_sample, job_id = int(argv[3]), int(argv[4])

    if n_devices is not None and n_devices > 1 and \
            "WORLD_SIZE" not in os.environ:
        print(f"--devices={n_devices} runs one process per card: launch "
              f"with torchrun --nproc_per_node={n_devices} -m "
              f"cornell_moe_tpu_torch.main ... --devices={n_devices}")
        return 1
    registry = {**SYNTHETIC_FUNCTIONS, **REAL_FUNCTIONS}
    if obj_func_name not in registry:
        print(f"unknown objective {obj_func_name!r}; choices: "
              f"{sorted(SYNTHETIC_FUNCTIONS)} + {list(REAL_FUNCTIONS)}")
        return 1
    objective_func = registry[obj_func_name]()
    if len(argv) > 5 and argv[5] == "HeSBO":
        effective_dim = int(argv[6]) if len(argv) > 6 else 2
        objective_func = hesbo.Projection(effective_dim, objective_func,
                                          seed=job_id)
    num_iterations = int(argv[7]) if len(argv) > 7 else 10

    owns_group = n_devices is not None and not dist.is_initialized()
    try:
        bo = BayesianOptimizer(
            objective_func=objective_func, method=method,
            num_to_sample=num_to_sample,
            noisy=objective_func._sample_var > 0, seed=job_id,
            device=device, n_devices=n_devices)
        history = bo.run(num_iterations)
        prints = bo.is_rank0
    finally:
        if owns_group and dist.is_initialized():
            dist.destroy_process_group()
    if prints:
        best = min(h["true_value"] for h in history)
        print(f"final best recommended value: {best:.6f} "
              f"(true minimum {objective_func._min_value})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
