"""The control of the comparison that decides ``correct``: the port's own
float32 path (kernels B and C), the precision below a float64
configuration, put in the program's place at the cell's own size and
traffic, judged by the same readings and held to the same limits.  It has
to come out not correct.  Not run by the benchmark's own runs.

    python3 -m cmoe_bench.control --workload <cell> --seconds <s> \
        --seeds <n> [<n> ...]

Each seed is one process (a short window of the cell); one JSON line per
seed.
"""

import argparse
import json
import subprocess
import sys

from cmoe_bench import run


def one(workload: str, seed: int, seconds: float) -> dict:
    bench = run.load_json(run.CHECKOUT / "BENCHMARK.json")
    if not run.torch.cuda.is_available():
        raise run.Fail("no CUDA card")
    spec = run.cell(bench, workload)
    if spec.cfg["dtype"] != "float64":
        raise run.Fail(f"no control for a {spec.cfg['dtype']} "
                       "configuration")
    low = spec._replace(cfg=dict(spec.cfg, dtype="float32"))
    res, extra = run.run_cell(low, seed, seconds, False,
                              run.torch.device("cuda", 0))
    return {"workload": workload, "seed": seed, "control": "float32",
            "iterations": extra["iterations"],
            "readings": extra["readings"], "checks": res["checks"],
            "correct": res["correct"], "metrics": res["metrics"]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--one", action="store_true",
                   help="run the first seed in this process")
    args = p.parse_args(argv)
    if args.one:
        print(json.dumps(run.finite_or_none(
            one(args.workload, args.seeds[0], args.seconds))), flush=True)
        return 0
    rc = 0
    for seed in args.seeds:
        proc = subprocess.run(
            [sys.executable, "-m", "cmoe_bench.control", "--one",
             "--workload", args.workload, "--seconds", str(args.seconds),
             "--seeds", str(seed)], capture_output=True, text=True,
            cwd=run.CHECKOUT)
        lines = proc.stdout.strip().splitlines()
        if proc.returncode or not lines:
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "rc": proc.returncode,
                              "stderr": proc.stderr[-2000:]}), flush=True)
            rc = 1
        else:
            print(lines[-1], flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
