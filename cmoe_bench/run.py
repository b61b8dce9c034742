"""Run one cell of ``BENCHMARK.json`` and print its result as the last line
of standard output.

    python3 -m cmoe_bench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout.  Set-up (from process start to the first
timed iteration, ``setup_s``): the kernel library from the port's build
directory inside the checkout (built there on the first run), the
driver's design and its training on the configuration's observations,
the saved state and one warm cycle.  Then the window (``loop.Loop``),
with ``--trace 1`` the profiler over its first cycle.  After the window:
the peak memory, a check that no JAX module was loaded, the program's
state freed, and the comparison with the plain reference (``check``).
With ``--trace 0`` the metrics are the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics (``metrics/<name>.py``).
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import NamedTuple  # noqa: E402

ROOT = Path(__file__).resolve().parent
CHECKOUT = ROOT.parent
# the caches a program could use, at fixed paths inside the checkout
os.environ["TORCH_EXTENSIONS_DIR"] = str(CHECKOUT / ".bench_cache" /
                                         "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(CHECKOUT / ".bench_cache" / "triton")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from cmoe_bench import check, trace as trace_mod  # noqa: E402
from cmoe_bench.loop import Loop  # noqa: E402
from cmoe_bench.objectives import Objective  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "cornell_moe_tpu")
GIB = 2 ** 30


class Fail(RuntimeError):
    """A run that prints no result."""


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} &
                  set(FORBIDDEN))


def guard(where: str) -> None:
    found = forbidden_modules()
    if found:
        raise Fail(f"{where}: loaded {', '.join(found)}")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Cell(NamedTuple):
    """A workload entry, its configuration, traffic and limits, and the
    end-to-end and per-layer metrics it reports."""

    entry: dict
    cfg: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list


def cell(bench: dict, workload: str) -> Cell:
    """The cell ``workload`` of ``bench``, its files found by name."""
    entry = next((w for w in bench["workloads"] if w["name"] == workload),
                 None)
    if entry is None:
        raise Fail(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    cfg = load_json(CHECKOUT / conf["file"])
    traffic = load_json(ROOT / "traffic" / f"{entry['traffic']}.json")
    limits = load_json(ROOT / "limits" / f"{workload}.json")

    def here(m):
        return workload in m.get("workloads", [workload])
    return Cell(entry, cfg, traffic, limits,
                [m for m in bench["end_to_end"] if here(m)],
                [m for m in bench["per_layer"] if here(m)])


def judgeable(cfg: dict) -> None:
    """Raises :class:`Fail` for a configuration the harness cannot judge:
    an objective it lacks, a ``num_fidelity`` or ``observations`` that do
    not fit the objective, a model the reference lacks
    (:func:`check.supported`)."""
    try:
        Objective(cfg["objective"], cfg.get("observations", []),
                  cfg["num_fidelity"])
        check.supported(cfg)
    except ValueError as e:
        raise Fail(f"configuration {cfg.get('name')!r}: {e}") from e


def metric_reader(name: str):
    """``metrics/<name>.py``'s module."""
    path = ROOT / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"cmoe_bench.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def provenance(device) -> dict:
    from cornell_moe_tpu_torch.ops import _build
    out = {"torch": torch.__version__, "cuda": torch.version.cuda,
           "library_hash": _build.source_hash(),
           "compile_seconds": _build.build_seconds}
    if torch.device(device).type == "cuda":
        out["card"] = torch.cuda.get_device_name(device)
        out["nccl"] = ".".join(map(str, torch.cuda.nccl.version()))
        try:
            smi = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], capture_output=True, text=True,
                timeout=20)
            out["nvidia_smi"] = smi.stdout.strip()
        except (OSError, subprocess.TimeoutExpired) as e:
            out["nvidia_smi"] = f"unavailable: {e}"
    return out


class Run:
    """What the metric readers read: the configuration, the window's
    iterations, the programs built in it and, in a traced run, the
    trace."""

    def __init__(self, cfg, dim, iterations, program_builds, trace, traced,
                 on_card):
        self.cfg = cfg
        self.on_card = on_card      # a card's peaks apply
        self.dim = dim
        self.iterations = iterations
        self.program_builds = program_builds
        self.trace = trace
        self.traced = traced        # the iterations inside the trace


def finite_or_none(x):
    """JSON-safe: a number that is not finite becomes None."""
    if isinstance(x, dict):
        return {k: finite_or_none(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [finite_or_none(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return None
    return x


def run_cell(spec: Cell, seed: int, seconds: float, traced: bool, device,
             start: float = None) -> dict:
    """One run of a cell on ``device``: returns the result object (its
    keys in the contract's order, the compared numbers last) and the
    run's details (``extra``)."""
    start = T0 if start is None else start
    cfg, limits = spec.cfg, spec.limits
    judgeable(cfg)
    if torch.device(device).type == "cuda":
        from cornell_moe_tpu_torch.ops import _build
        _build.library()
    library_s = time.perf_counter() - start
    loop = Loop(cfg, spec.traffic, seed, device)
    setup_parts = dict(library=library_s, **loop.setup())
    guard("after set-up")
    builds0 = len(loop.bo.program_cache)
    setup_s = time.perf_counter() - start

    prof, stack = None, contextlib.ExitStack()

    def on_cycle(cycle, starting):
        """The profiler over the window's first cycle."""
        nonlocal prof
        if not traced or cycle != 0:
            return
        if starting:
            prof = stack.enter_context(torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]))
            stack.enter_context(torch.profiler.record_function(
                "cmoe.window"))
        else:
            loop.spans.sync()
            stack.close()

    window_s = loop.window(seconds, on_cycle)
    builds = len(loop.bo.program_cache) - builds0
    peak = torch.cuda.max_memory_allocated(device) \
        if torch.device(device).type == "cuda" else 0
    guard("after the window")
    its = loop.iterations
    tr = None
    if prof is not None:
        tr = trace_mod.summarize(trace_mod.profiler_events(prof))
        prof = None
    records, domain = loop.records, np.array(loop.domain)
    loop.close()
    loop = None
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()

    readings = check.judge(records, cfg, domain, seed, device)
    checks = check.compare(readings, limits)
    times = [it["seconds"] for it in its]
    failed = sum(not it["finite"] for it in its)
    metrics = {}
    if not traced:
        values = {"iter_s": sum(times) / len(times),
                  "iter_p90_s": float(np.percentile(times, 90)),
                  "peak_mem_gib": peak / GIB, "setup_s": setup_s}
        for m in spec.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    else:
        run = Run(cfg, domain.shape[0], its, builds, tr,
                  [it for it in its if it["cycle"] == 0],
                  torch.device(device).type == "cuda")
        for m in spec.per_layer:
            value = metric_reader(m["name"]).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if torch.device(device).type == "cuda"
           else "cpu",
           "kind": torch.cuda.get_device_name(device)
           if torch.device(device).type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": failed == 0 and all(c["ok"]
                                             for c in checks.values()),
              "attempted": len(its), "failed": failed, "metrics": metrics,
              "device": dev}
    if traced and tr is not None:
        dev["busy_s"] = tr.busy_s
        dev["window_s"] = tr.window_s
        result["breakdown"] = trace_mod.breakdown(tr)
    result["checks"] = {n: [c["value"], c["limit"]]
                        for n, c in checks.items()}
    extra = {"window_s": window_s, "iterations": len(its),
             "setup_s": setup_s, "setup_parts": setup_parts,
             "program_builds": builds,
             "chain_steps": [it["chain_steps"] for it in its],
             "iteration_s": times, "readings": readings}
    return finite_or_none(result), finite_or_none(extra)


def emit(result: dict, extra: dict, prov: dict) -> None:
    """The run's lines: the provenance and the readings on standard
    output, each compared number beside its limit as the last lines of
    standard error, the result as the last line of standard output."""
    print(json.dumps({"provenance": prov}), flush=True)
    print(json.dumps({"extra": extra}), flush=True)
    for name, (value, limit) in result["checks"].items():
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    bench_path = CHECKOUT / "BENCHMARK.json"
    try:
        bench = load_json(bench_path)
        entry = next((w for w in bench["workloads"]
                      if w["name"] == args.workload), None)
        if entry is None:
            raise Fail(f"no workload {args.workload!r}")
        if not torch.cuda.is_available():
            raise Fail("no CUDA card")
        if torch.cuda.device_count() < entry["chips"]:
            raise Fail(f"{torch.cuda.device_count()} cards, the cell asks "
                       f"for {entry['chips']}")
        device = torch.device("cuda", 0)
        result, extra = run_cell(cell(bench, args.workload), args.seed,
                                 args.seconds, bool(args.trace), device)
        guard("before the result")
        prov = provenance(device)
    except (Fail, OSError, KeyError, ImportError) as e:
        print(f"cmoe_bench: {type(e).__name__}: {e}", file=sys.stderr)
        return 1
    emit(result, extra, prov)
    return 0


if __name__ == "__main__":
    sys.exit(main())
