"""The benchmark's harness on the CPU: its data files found by name, the
yardstick's bounds, the trace reduction, the import guard, and a toy cell
end to end (20 observations, q = 2, 8 multistarts) whose last line has the
contract's keys and reads correct."""

import io
import json
import math
import subprocess
import sys
import time
from contextlib import redirect_stdout
from pathlib import Path

import pytest
import torch

from cmoe_bench import check, roofline, run, trace

ROOT = Path(__file__).resolve().parents[2]
TOY = Path(__file__).resolve().parent / "toy.json"
RESULT_KEYS = {"correct", "attempted", "failed", "metrics", "device",
               "checks"}


def bench() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def toy_cell(workload="qkg-branin-f64.refit", traffic="refit", toy=TOY,
             recommend_points=1000) -> run.Cell:
    """The toy configuration ``toy`` in place of a cell's, under a traffic
    mix of the benchmark with ``recommend_points`` guesses (None: the
    mix's own), held to that cell's limits."""
    spec = run.cell(bench(), workload)
    t = json.loads((run.ROOT / "traffic" / f"{traffic}.json").read_text())
    t.update(iterations_per_cycle=1)
    if recommend_points is not None:
        t.update(recommend_points=recommend_points)
    return spec._replace(cfg=json.loads(Path(toy).read_text()), traffic=t)


@pytest.mark.parametrize("workload", [w["name"] for w in bench()
                                      ["workloads"]])
def test_every_cell_finds_its_files(workload):
    b = bench()
    spec = run.cell(b, workload)
    conf = next(c for c in b["configs"] if c["name"] == spec.entry["config"])
    assert spec.cfg["name"] == conf["name"]
    assert spec.cfg["reduced"] == conf["reduced"]
    assert spec.limits.get("data_mismatch") == 0
    assert set(spec.limits) <= set(check.READINGS)
    assert spec.traffic["points"] == "uniform"
    names = {m["name"] for m in spec.end_to_end}
    assert {"setup_s", "iter_s"} <= names
    assert spec.per_layer


@pytest.mark.parametrize("metric", [m["name"] for m in bench()
                                    ["per_layer"]])
def test_every_metric_reader_declares_what_benchmark_json_says(metric):
    m = next(x for x in bench()["per_layer"] if x["name"] == metric)
    mod = run.metric_reader(metric)
    assert (mod.LAYER, mod.UNIT, mod.SOURCE, mod.MOVES) == (
        m["layer"], m["unit"], m["source"], m["moves"])
    assert callable(mod.read)


def test_benchmark_json_keeps_the_contract_shape():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert [w["name"] for w in b["workloads"]] == ["qkg-branin-f64.refit"]
    assert all(w["chips"] == 1 and len(w["why"]) <= 200
               for w in b["workloads"])
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert set(e2e) == {"iter_s", "iter_p90_s", "peak_mem_gib", "setup_s"}
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    for c in b["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith("cmoe_bench/")


def test_roofline_reproduces_the_kernel_table():
    assert roofline.lml_bound(8, 512, 2, "matern_2.5")["ms"] == \
        pytest.approx(0.002169175402020202, rel=1e-12)
    assert roofline.covariance_bound(16, 512, 2, "matern_2.5")["ms"] == \
        pytest.approx(0.0050191856716417915, rel=1e-12)
    assert roofline.lml_bound(8, 512, 2, "matern_2.5")["pipe"] == "tf32x3"


def test_trace_reduction():
    ev = [{"name": "cmoe.window", "device": "cpu", "start_ns": 0,
           "end_ns": 1000},
          {"name": "cmoe.suggest", "device": "cpu", "start_ns": 0,
           "end_ns": 400},
          {"name": "cmoe.observe", "device": "cpu", "start_ns": 400,
           "end_ns": 1000},
          {"name": "k1", "device": "cuda", "start_ns": 100, "end_ns": 300},
          {"name": "k2", "device": "cuda", "start_ns": 250, "end_ns": 350},
          {"name": "k1", "device": "cuda", "start_ns": 500, "end_ns": 900},
          {"name": "aten::mm", "device": "cpu", "start_ns": 0,
           "end_ns": 10}]
    tr = trace.summarize(ev)
    assert tr.busy == [(100, 350), (500, 900)]
    assert tr.busy_s == pytest.approx(650e-9)
    assert tr.window_s == pytest.approx(1000e-9)
    assert tr.busy_in_spans("observe") == pytest.approx(400e-9)
    assert tr.op_seconds["k1"] == pytest.approx(600e-9)
    assert tr.idle_by_span == pytest.approx({"suggest": 250e-9,
                                             "observe": 100e-9})
    bd = trace.breakdown(tr)
    assert bd["device_ops"][0][0] == "k1"
    assert bd["idle_gaps"][0] == ["suggest", pytest.approx(250e-9)]


def test_import_guard_compares_whole_top_level_names(monkeypatch):
    assert "cornell_moe_tpu_torch" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert run.forbidden_modules() == ["jax"]
    with pytest.raises(run.Fail):
        run.guard("test")


def test_reference_and_check_load_nothing_of_the_port():
    code = ("import sys; import cmoe_bench.check, cmoe_bench.reference.gp; "
            "bad = sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'cornell_moe_tpu', "
            "'cornell_moe_tpu_torch'}); print(bad)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, "-m", "cmoe_bench.run", "--workload",
         "qkg-branin-f64.refit", "--seed", "1", "--seconds", "1", "--trace",
         "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert out.stdout == ""


@pytest.mark.parametrize("seed", [2 ** 31 + 12345, 5 * 10 ** 9 + 7])
def test_toy_cell_end_to_end_on_the_cpu(seed):
    result, extra = run.run_cell(toy_cell(), seed, 1.0, False, "cpu",
                                 start=time.perf_counter())
    buf = io.StringIO()
    with redirect_stdout(buf):
        run.emit(result, extra, {"card": "none"})
    last = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert set(last) == RESULT_KEYS
    assert list(last)[-1] == "checks"
    assert last["correct"] is True, last["checks"]
    assert last["attempted"] >= 1 and last["failed"] == 0
    assert set(last["metrics"]) == {"iter_s", "iter_p90_s", "peak_mem_gib",
                                    "setup_s"}
    assert all(math.isfinite(m["value"]) for m in last["metrics"].values())
    assert extra["program_builds"] == 0


@pytest.mark.cuda
def test_one_short_run_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, "-m", "cmoe_bench.run", "--workload",
         "qkg-branin-f64.refit", "--seed", "5", "--seconds", "3", "--trace",
         "1"], cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    last = json.loads(out.stdout.strip().splitlines()[-1])
    assert last["correct"] is True
    assert last["device"]["busy_s"] > 0
