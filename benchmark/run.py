#!/usr/bin/env python3
"""Run one cell of the benchmark of `humaniflow_torch` once, on the GPUs of
this machine:

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the repository's root.  It loads the cell of BENCHMARK.json, its
configuration and its traffic, makes every input from the seed, builds the
program's objects and warms up the cell's shapes (set-up), drives the cell's
entry in a closed loop for --seconds, then judges a sample of the window's
outputs, drawn from the seed, against the plain reference (benchmark/
reference/), and prints one JSON line last on standard output.  With
--trace 0 the line holds the cell's end-to-end metrics; with --trace 1 its
per-layer metrics, read from plain calls, spans around the layers' entries
and a torch.profiler trace of a few calls.  Every metric has its reader,
benchmark/metrics/<name>.py.  It exits non-zero,
with no result, without enough CUDA devices, or when JAX or the JAX package
was loaded.
"""

import time

START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "humaniflow_tpu")
WARMUP_CALLS = 2
TRACE_PLAIN_SHARE = 0.35  # of a traced window: plain calls first,
TRACE_SPAN_SHARE = 0.35  # then calls with spans, then the profiled calls


def _cache_dirs():
    """Build and kernel caches at fixed paths inside the checkout."""
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(ROOT, "build", "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(ROOT, "build", "torch_extensions"))
    os.environ.pop("HFT_FUSED_LEVEL", None)  # the program's default path, as users run it
    os.environ["USE_FLAX"] = "0"


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


class Reservoir:
    """A uniform sample of `size` items of a stream, drawn from `rng`."""

    def __init__(self, size: int, rng: random.Random):
        self.size, self.rng, self.items, self.seen = size, rng, [], 0

    def offer(self, make):
        self.seen += 1
        if len(self.items) < self.size:
            self.items.append(make())
        else:
            j = self.rng.randrange(self.seen)
            if j < self.size:
                self.items[j] = make()


def _drive(entry, seconds: float, first: int, call, keep, latencies: list):
    """Calls call(i) for i = first, first + 1, ... until `seconds` have
    passed, each ending in a device synchronise; appends each call's
    host-clock seconds to `latencies` and offers its output to `keep`.
    Returns (attempted, failed, seconds taken)."""
    from benchmark.harness import trace as tr

    attempted, failed = 0, 0
    t0 = time.perf_counter()
    while time.perf_counter() < t0 + seconds:
        i = first + attempted
        attempted += 1
        t = time.perf_counter()
        try:
            out = call(i)
            tr.sync(entry.device)
        except RuntimeError as e:  # a failed call counts, and makes the run not correct
            print(f"call {i} failed: {e}", file=sys.stderr)
            failed += 1
            continue
        latencies.append(time.perf_counter() - t)
        keep.offer(lambda: entry.keep(i, out))
        del out
    return attempted, failed, time.perf_counter() - t0


def run_cell(cell, seed: int, seconds: float, trace: bool, device="cuda", start=None) -> dict:
    """One run of a cell; returns the result line as a dict (and the numbers
    judged, under "checked").

    With trace, the window has three phases: plain calls as an untraced run
    makes them (the calls, window and latencies that the rates, the MFU and
    the idle share are read over), calls with spans around the layers, and
    `profiled_calls` calls under torch.profiler."""
    import torch

    from benchmark.harness import trace as tr
    from benchmark.harness.cell import make_entry, metric_reader

    start = time.perf_counter() if start is None else start
    entry = make_entry(cell, seed, device)
    for k in range(WARMUP_CALLS):
        entry.call(k)
        if trace:
            entry.traced_call(k, tr.Spans(device))
    tr.sync(device)
    gc.collect()
    gc.freeze()  # what set-up made stays out of the collector's scans in the window
    setup_s = time.perf_counter() - start

    keep = Reservoir(cell.traffic["check_calls"], random.Random(seed))
    latencies, spans = [], tr.Spans(device)
    attempted, failed, window_s = _drive(entry, seconds * (TRACE_PLAIN_SHARE if trace else 1.0), 0, entry.call,
                                         keep, latencies)
    calls = len(latencies)
    device_trace = None
    if trace:
        a, f, _ = _drive(entry, seconds * TRACE_SPAN_SHARE, attempted, lambda i: entry.traced_call(i, spans),
                         keep, [])
        attempted, failed = attempted + a, failed + f
        device_trace = tr.profile_calls(lambda k: entry.traced_call(attempted + k, tr.Spans(device)),
                                        cell.traffic["profiled_calls"], device)
    memory_peak = torch.cuda.max_memory_allocated(device) if torch.device(device).type == "cuda" else 0
    found = forbidden_modules()
    if found:
        raise SystemExit(f"forbidden modules loaded: {found}")

    entry.free()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    checked = judge(entry, keep.items, cell.traffic["limits"])
    correct = failed == 0 and len(keep.items) > 0 and all(c["ok"] for c in checked.values())

    run = {"cell": cell, "setup_s": setup_s, "spans": spans, "trace": device_trace, "calls": calls,
           "window_s": window_s, "images_per_call": entry.images_per_call, "latencies": latencies}
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = metric_reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    result = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics,
              "device": _device(device, cell.chips, memory_peak, device_trace)}
    if device_trace is not None:
        result["breakdown"] = {"device_ops": device_trace.top_ops(), "idle_gaps": device_trace.idle_gaps()}
    result["checked"] = {k: {"value": c["value"], "limit": c["limit"]} for k, c in checked.items()}
    return result


def judge(entry, kept: list, limits: dict) -> dict:
    """The widest gap of each number that the traffic gives a limit, over the
    kept calls, against its limit."""
    worst = {}
    for item in entry.judged(kept):
        got = item[1]
        want = entry.reference(item, "float32", judged=got)
        for name, value in entry.numbers(got, want).items():
            if name in limits:
                worst[name] = max(worst.get(name, value), value)  # a NaN reading is infinite already
        del want
    return {name: {"value": v, "limit": limits[name], "ok": v <= limits[name]} for name, v in worst.items()}


def _device(device, chips: int, memory_peak: int, device_trace) -> dict:
    import torch

    if torch.device(device).type == "cuda":
        out = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
               "memory_peak_bytes": int(memory_peak)}
    else:
        out = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    if device_trace is not None:
        out.update(busy_s=device_trace.busy_s, window_s=device_trace.window_s)
    return out


def _power_limit() -> str:
    """The card's name and power limit as nvidia-smi reads them, or why not."""
    import subprocess

    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=30).stdout.strip() or "not read"
    except (OSError, subprocess.SubprocessError) as e:
        return f"not read ({e})"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _cache_dirs()
    sys.path.insert(0, ROOT)

    import torch

    from benchmark.harness.cell import load_cell

    cell = load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"needs {cell.chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), start=START)
    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    print(f"card: {_power_limit()}", file=sys.stderr)  # the MFU and rooflines hold at this limit
    for name, c in result["checked"].items():
        print(f"check {name}: {c['value']:.6g} (limit {c['limit']:.6g})", file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
