"""Every cell end to end at a tiny size on the CPU (the kernels' plain
versions run there), with and without tracing; the command's refusals."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark.harness.cell import REPO_ROOT, entry_class, load_cell, make_entry
from benchmark.run import run_cell
from benchmark.tests._tiny import SEED, tiny_cell, workloads


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("workload", workloads())
def test_cell_runs_and_is_correct_on_the_cpu(workload, trace):
    cell = tiny_cell(workload)
    r = run_cell(cell, SEED, 0.5, trace, device="cpu")
    assert r["correct"], r["checked"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert list(r)[-1] == "checked"
    assert set(r["checked"]) == set(cell.traffic["limits"])
    if trace:
        # no device on the CPU: the readers of the device and of the chip's peak give nothing, the spans something
        device_metrics = {m["name"] for m in cell.per_layer if m["source"] == "device_trace" or "mfu" in m["name"]}
        assert device_metrics.isdisjoint(r["metrics"])
        assert r["metrics"] and all(v["value"] > 0 for v in r["metrics"].values())
    else:
        assert set(r["metrics"]) == {m["name"] for m in cell.end_to_end}
        assert all(v["value"] > 0 for v in r["metrics"].values())


def test_same_seed_same_inputs():
    cell = tiny_cell("r18_predict_n100")
    a, b = (make_entry(cell, SEED, "cpu") for _ in range(2))
    assert all((a.weights[k] == b.weights[k]).all() for k in a.weights)
    assert (a.pool[0]["images"] == b.pool[0]["images"]).all()
    assert all((x == y).all() for x, y in zip(a.pool[0]["noise"], b.pool[0]["noise"]))
    c = make_entry(cell, SEED + 1, "cpu")
    assert not (a.pool[0]["images"] == c.pool[0]["images"]).all()


def _command(cwd, env_extra=None):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", **(env_extra or {}))
    return subprocess.run([sys.executable, "benchmark/run.py", "--workload", "r18_predict_n100", "--seed", "1",
                           "--seconds", "1", "--trace", "0"], cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=300)


def test_the_command_refuses_to_run_without_a_card():
    p = _command(REPO_ROOT)
    assert p.returncode != 0
    assert p.stdout.strip() == "", "no result line without a card"
    assert "CUDA" in p.stderr


def test_the_command_fails_with_only_the_benchmark(tmp_path):
    """A directory with BENCHMARK.json and benchmark/ alone has no program to run."""
    shutil.copy(os.path.join(REPO_ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(REPO_ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _command(tmp_path)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_benchmark_json_names_existing_files():
    with open(os.path.join(REPO_ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for c in bench["configs"]:
        assert os.path.exists(os.path.join(REPO_ROOT, c["file"]))
    for w in bench["workloads"]:
        assert os.path.exists(os.path.join(REPO_ROOT, "benchmark", "traffic", f"{w['traffic']}.json"))
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert os.path.exists(os.path.join(REPO_ROOT, "benchmark", "metrics", f"{m['name']}.py"))
    for w in bench["workloads"]:
        assert callable(entry_class(load_cell(w["name"]).traffic["entry"]))
