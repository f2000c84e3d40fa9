"""The program-span readers and table (harness/program_spans.py): their
arithmetic on a hand-made trace, and every cell at a tiny size on the CPU
with the program's spans in its traced run."""

from types import SimpleNamespace

import pytest

from benchmark.harness import program_spans as ps
from benchmark.harness import trace as tr
from benchmark.harness.cell import make_entry, metric_reader
from benchmark.run import run_cell
from benchmark.tests._tiny import SEED, tiny_cell, workloads

# Two calls.  Call 1: train_step [0, 100] holding train_step.forward [10, 40] and
# train_step.backward [40, 90]; launch calls at 5 (in train_step itself), 20 and 30
# (forward), 50 (backward, the main thread) and 60 (backward, launched from the
# autograd engine's thread while the main thread waits in the span); a sync at 95.
# Call 2: train_step [200, 260] with forward [210, 250]; launches at 220 and 255;
# one launch outside any span at 150.
HOST = [
    ("train_step", 0, 100, 1), ("train_step.forward", 10, 40, 2), ("train_step.backward", 40, 90, 3),
    ("cudaLaunchKernel", 5, 6, 101), ("cudaLaunchKernel", 20, 21, 102), ("cudaLaunchKernel", 30, 31, 103),
    ("cudaLaunchKernel", 50, 51, 104), ("cudaLaunchKernelExC", 60, 61, 105), ("cudaStreamSynchronize", 95, 99, 106),
    ("aten::mul", 19, 22, 7),
    ("train_step", 200, 260, 8), ("train_step.forward", 210, 250, 9),
    ("cudaLaunchKernel", 220, 221, 107), ("cudaMemsetAsync", 255, 256, 108), ("cudaLaunchKernel", 150, 151, 109),
]
# kernels (name, start, end, id = their launch call's correlation id, linked op id)
KERNELS = [
    ("k_step", 10, 12, 101, 0), ("k_fwd_a", 22, 32, 102, 7), ("k_fwd_b", 32, 36, 103, 0),
    ("k_bwd_main", 55, 65, 104, 0), ("k_bwd_thread", 66, 70, 105, 0),
    ("k_out", 152, 154, 109, 0), ("k_fwd2", 224, 230, 107, 0), ("k_memset", 256, 258, 108, 0),
]
NAMES = ("train_step", "train_step.forward", "train_step.backward")


def _device_trace(kernels=True):
    return SimpleNamespace(_host=[(n, s, e) for n, s, e, _ in HOST], calls=2,
                           kernels=[(n, s, e) for n, s, e, _, _ in KERNELS] if kernels else [])


def test_span_launches_a_call():
    t = _device_trace()
    assert ps.span_launches(t, "train_step") == 7 / 2  # the backward thread's launch included
    assert ps.span_launches(t, "train_step.backward") == 2 / 2
    assert ps.span_launches(t, "train_step.forward") == 3 / 2
    assert ps.span_launches(t, "dist_infer") is None
    assert ps.span_launches(_device_trace(kernels=False), "train_step") is None  # no card
    assert ps.span_launches(None, "train_step") is None


def test_the_span_table():
    events = SimpleNamespace(host=HOST, kernels=KERNELS)
    summary = {"train_step": {"calls": 4, "host_s": 0.4, "self_s": 0.1, "counters": {"raster": 2}},
               "train_step.forward": {"calls": 4, "host_s": 0.2, "self_s": 0.2, "counters": {"h2d_bytes": 4e6}}}
    out = ps.span_table(events, NAMES, 2, summary, phase_calls=4)
    rows = out["rows"]
    assert out["kernels_matched"] == 1.0
    assert rows["train_step"]["launches"] == 7 / 2 and rows["train_step"]["self_launches"] == 2 / 2
    assert rows["train_step.forward"]["self_launches"] == 3 / 2
    assert rows["train_step.backward"]["self_launches"] == 2 / 2
    assert rows[ps.OUTSIDE]["self_launches"] == 1 / 2
    assert rows["train_step"]["syncs"] == 1 / 2 and rows[ps.OUTSIDE]["syncs"] == 0
    # busy: each kernel under the innermost span around its launch call
    assert rows["train_step"]["busy_ms"] == pytest.approx((2 + 2) / 1e3 / 2)
    assert rows["train_step.forward"]["busy_ms"] == pytest.approx((14 + 6) / 1e3 / 2)
    assert rows["train_step.backward"]["busy_ms"] == pytest.approx(14 / 1e3 / 2)  # the thread's kernel included
    assert rows[ps.OUTSIDE]["busy_ms"] == pytest.approx(2 / 1e3 / 2)
    # idle: gaps 12-22 (mid 17, forward), 36-55 (45.5, backward), 65-66 (65.5, backward), 70-152 (111, outside),
    # 154-224 (189, outside), 230-256 (243, forward)
    assert rows["train_step.forward"]["idle_ms"] == pytest.approx((10 + 26) / 1e3 / 2)
    assert rows["train_step.backward"]["idle_ms"] == pytest.approx((19 + 1) / 1e3 / 2)
    assert rows[ps.OUTSIDE]["idle_ms"] == pytest.approx((82 + 70) / 1e3 / 2)
    assert "idle_ms" not in rows["train_step"]
    # from the program's summary of 4 calls
    assert rows["train_step"]["host_ms"] == pytest.approx(100) and rows["train_step"]["self_ms"] == pytest.approx(25)
    assert rows["train_step"]["raster"] == 0.5 and rows["train_step.forward"]["h2d_mb"] == 1.0
    assert list(rows)[0] == "train_step"


def test_a_kernel_without_its_launch_call_goes_by_its_op():
    host = [h for h in HOST if h[3] != 102]  # the launch call of k_fwd_a lost: its op (id 7, at 19) places it
    out = ps.span_table(SimpleNamespace(host=host, kernels=KERNELS), NAMES, 2)
    assert out["kernels_matched"] == 1.0
    assert out["rows"]["train_step.forward"]["busy_ms"] == pytest.approx((14 + 6) / 1e3 / 2)


ROOT = {"r18_predict_n100": "predict", "w48_predict_uncropped_n50": "hrnet", "r18_train_b72": "train_step"}


@pytest.mark.parametrize("workload", workloads())
def test_a_traced_run_reads_the_program_spans(workload):
    """The launch readers on a tiny traced run on the CPU: the program's spans
    are host events of a profiled call, which has no CUDA event, so each
    reader reports nothing."""
    cell = tiny_cell(workload)
    r = run_cell(cell, SEED, 0.5, True, device="cpu")
    reported = {m["name"] for m in cell.per_layer} & set(ps.READINGS)
    assert reported, "every cell reports one of the program-span metrics"
    for name in ps.READINGS:
        assert name not in r["metrics"], name
    assert metric_reader("train_step_launches")({"trace": None}) is None
    entry = make_entry(cell, SEED, "cpu")
    t = tr.profile_calls(entry.call, 1, "cpu")
    entry.free()
    assert ROOT[workload] in {n for n, _, _ in ps.host_events(t)}
    assert ps.span_launches(t, ROOT[workload]) is None


@pytest.mark.parametrize("workload", workloads())
def test_the_span_table_of_a_tiny_cell(workload):
    cell = tiny_cell(workload)
    out = ps.run(cell, SEED, 0.5, device="cpu")
    rows = out["rows"]
    assert rows[ROOT[workload]]["host_ms"] > 0 and rows[ROOT[workload]]["calls"] >= 1
    assert out["plain"]["calls"] >= 1 and out["spans"]["calls"] >= 1
    assert out["kernels_matched"] is None  # no kernels on the CPU
    assert set(out["readings"]) == set(ps.READINGS)
