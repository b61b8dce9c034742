"""Experiment driver command line.

Counterpart of ``examples/main.py``:

    python -m cornell_moe_tpu_torch.main <func> <KG|EI> <q> <job_id>
        [HeSBO|none] [eff_dim] [iters] [--device=cpu]

e.g.  python -m cornell_moe_tpu_torch.main Branin EI 2 1 none 0 1
      python -m cornell_moe_tpu_torch.main Hartmann6 EI 1 1 HeSBO 2 1

``<func>`` is a name of ``utils.synthetic_functions.SYNTHETIC_FUNCTIONS``;
``HeSBO <eff_dim>`` optimizes it in a count-sketch embedding of that
dimension (seeded by the job id); ``iters`` defaults to 10.  The run takes
``cuda:0`` unless ``--device=cpu`` is given.  The last line printed is the
best true value among the iterations' recommendations.
"""

from __future__ import annotations

import sys

from cornell_moe_tpu_torch.bayes_opt import BayesianOptimizer
from cornell_moe_tpu_torch.utils import hesbo
from cornell_moe_tpu_torch.utils.synthetic_functions import \
    SYNTHETIC_FUNCTIONS

REAL_FUNCTIONS = ("KISSGP", "CIFAR10")


def main(argv) -> int:
    """Run the command line ``argv`` (``sys.argv``: the program name
    first); returns the exit code."""
    argv = list(argv)
    device = None
    for a in list(argv):
        if a.startswith("--devices"):
            print("--devices: scale-out over several cards is not ported "
                  "yet (ROADMAP Queue 1 item 6)")
            return 1
        if a.startswith("--device"):
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

    if obj_func_name in REAL_FUNCTIONS:
        print(f"{obj_func_name}: utils/real_functions.py is not ported yet "
              "(ROADMAP Queue 1)")
        return 1
    if obj_func_name not in SYNTHETIC_FUNCTIONS:
        print(f"unknown objective {obj_func_name!r}; choices: "
              f"{sorted(SYNTHETIC_FUNCTIONS)}")
        return 1
    objective_func = SYNTHETIC_FUNCTIONS[obj_func_name]()
    if len(argv) > 5 and argv[5] == "HeSBO":
        effective_dim = int(argv[6]) if len(argv) > 6 else 2
        objective_func = hesbo.Projection(effective_dim, objective_func,
                                          seed=job_id)
    num_iterations = int(argv[7]) if len(argv) > 7 else 10

    bo = BayesianOptimizer(
        objective_func=objective_func, method=method,
        num_to_sample=num_to_sample, noisy=objective_func._sample_var > 0,
        seed=job_id, device=device)
    history = bo.run(num_iterations)
    best = min(h["true_value"] for h in history)
    print(f"final best recommended value: {best:.6f} "
          f"(true minimum {objective_func._min_value})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
