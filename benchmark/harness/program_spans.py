"""The program's own spans (`humaniflow_torch/utils/tracing.py`) read
against the device trace: per span, its host time, the CUDA runtime's
launch and sync calls inside it, the device's busy and idle time under it
and its counters.

The program's span is a host range of the trace (as an aten operator is
one) whenever a torch.profiler session runs, so every profiled call of a
traced run carries the program's layers among its host events, with no
harness span needed.  The readers of `benchmark/metrics/` take from such a
trace (a `trace.DeviceTrace`) counts only, which the profiler does not
stretch:

* `span_launches(trace, name)`: the runtime's launch calls whose start lies
  inside the span's events, a call, from any thread (the autograd engine
  launches the backward from its own thread while the caller waits in the
  span); None where the trace holds no event of the span (a program
  without it) or no kernel (no card).

A span's host time is not read there: the profiled calls run under the
profiler and after the harness's synchronising spans, so they are not the
call users make.  The table below takes it from calls with the program's
tracing on and no profiler.

The whole table of a cell comes from

    python3 -m benchmark.harness.program_spans --workload <cell> --seed <n> --seconds <s>

on the card: the cell's set-up as a run makes it, plain calls for 35% of
--seconds, then calls with the program's tracing on for 15% (no harness
span, no profiler: the tracing's cost is their rate against the plain
calls'), then the traffic's `profiled_calls` plain calls under
torch.profiler with tracing on, which give each span's runtime calls, busy
and idle.  A kernel belongs to the innermost program span that covers its
launch call on the host clock; an idle gap between kernels to the
innermost program span at the gap's middle.  What no span covers is the
`(outside)` row.  One JSON line on standard output.
"""

import argparse
import bisect
import contextlib
import json
import random
import sys
import time
from collections import defaultdict

LAUNCH_CALLS = frozenset(("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                          "cudaGraphLaunch", "cudaMemcpyAsync", "cudaMemsetAsync"))
SYNC_CALLS = frozenset(("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize", "cudaMemcpy"))
OUTSIDE = "(outside)"
SPAN_SHARE = 0.15  # of --seconds: the calls with the program's tracing on, after the plain ones


def _intervals(host, name):
    return sorted((s, e) for n, s, e in host if n == name)


def _inside(starts, intervals) -> int:
    """How many of the sorted `starts` lie inside one of the intervals (which
    do not overlap: instances of one span on one thread)."""
    return sum(bisect.bisect_right(starts, e) - bisect.bisect_left(starts, s) for s, e in intervals)


def host_events(trace):
    """A DeviceTrace's host events (name, start µs, end µs), which it keeps
    private."""
    return trace._host


def span_launches(trace, name: str):
    """The runtime's launch calls a profiled call inside program span `name`."""
    if trace is None or not trace.kernels:
        return None
    host = host_events(trace)
    spans = _intervals(host, name)
    if not spans:
        return None
    starts = sorted(s for n, s, _ in host if n in LAUNCH_CALLS)
    return _inside(starts, spans) / trace.calls


class Events:
    """The events of a profiler session that the table reads: host events
    (name, start µs, end µs, id) and kernels (name, start µs, end µs, id,
    linked correlation id)."""

    def __init__(self, prof):
        import torch

        self.host, self.kernels = [], []
        for e in prof.events():
            if e.time_range.elapsed_us() <= 0:
                continue
            if e.device_type == torch.autograd.DeviceType.CUDA:
                self.kernels.append((e.name, e.time_range.start, e.time_range.end, e.id,
                                     getattr(e, "linked_correlation_id", 0)))
            else:
                self.host.append((e.name, e.time_range.start, e.time_range.end, e.id))


class Innermost:
    """The innermost of a set of properly nested intervals at a time."""

    def __init__(self, spans):
        # an outer span sorts before the spans it holds (earlier start, or the same start and a later end)
        self.spans = sorted(spans, key=lambda x: (x[1], -x[2]))
        self.starts = [s for _, s, _ in self.spans]

    def at(self, t):
        j = bisect.bisect_right(self.starts, t) - 1
        while j >= 0:
            name, s, e = self.spans[j]
            if e >= t:
                return name
            j -= 1
        return None


def span_table(events: Events, names, calls: int, summary: dict = None, phase_calls: int = None) -> dict:
    """Per program span (`names`), a profiled call: launches (runtime launch
    calls inside it, its children's included) and self_launches (those of no
    child), syncs (inside it), busy_ms (the union of the kernels it launched
    itself) and idle_ms (the gaps between kernels whose middle lies in it and
    in no child); with the program's summary of `phase_calls` calls, host_ms
    and self_ms a call, instances a call and the counters a call
    (h2d_bytes as h2d_mb).  The (outside) row holds what no span covers.
    Also: the share of kernels matched to a launch call."""
    from benchmark.harness.trace import _union

    names = set(names)
    spans = [(n, s, e) for n, s, e, _ in events.host if n in names]
    inner = Innermost(spans)
    runtime = [(n, s, i) for n, s, _, i in events.host if n in LAUNCH_CALLS]
    syncs = sorted(s for n, s, _, _ in events.host if n in SYNC_CALLS)
    launch_starts = sorted(s for _, s, _ in runtime)
    rows = defaultdict(lambda: defaultdict(float))
    for name in names:
        iv = sorted((s, e) for n, s, e in spans if n == name)
        rows[name]["launches"] = _inside(launch_starts, iv) / calls
        rows[name]["syncs"] = _inside(syncs, iv) / calls
    for _, s, _ in runtime:
        rows[inner.at(s) or OUTSIDE]["self_launches"] += 1 / calls
    rows[OUTSIDE]["syncs"] = sum(1 for s in syncs if inner.at(s) is None) / calls

    by_corr = {i: s for _, s, i in runtime}
    by_id = {i: s for n, s, _, i in events.host if n not in LAUNCH_CALLS}  # the ops and spans, by their own ids
    mine, matched = defaultdict(list), 0
    for _, ks, ke, kid, linked in events.kernels:
        t = by_corr.get(kid)
        if t is None:
            t = by_id.get(linked) if linked else None
        matched += t is not None
        mine[(inner.at(t) if t is not None else None) or OUTSIDE].append((ks, ke))
    for name, iv in mine.items():
        rows[name]["busy_ms"] = _union(iv)[0] / 1e3 / calls
    for s, e in _union([(s, e) for _, s, e, _, _ in events.kernels])[1]:
        rows[inner.at(0.5 * (s + e)) or OUTSIDE]["idle_ms"] += (e - s) / 1e3 / calls

    if summary:
        for name, v in summary.items():
            r = rows[name]
            r["calls"] = v["calls"] / phase_calls
            r["host_ms"] = 1e3 * v["host_s"] / phase_calls
            r["self_ms"] = 1e3 * v["self_s"] / phase_calls
            for k, n in v["counters"].items():
                if k == "h2d_bytes":
                    r["h2d_mb"] = n / 1e6 / phase_calls
                else:
                    r[k] = n / phase_calls
    table = {name: dict(r) for name, r in sorted(rows.items(), key=lambda kv: -kv[1].get("host_ms", 0.0))}
    return {"rows": table, "kernels_matched": matched / len(events.kernels) if events.kernels else None}


def run(cell, seed: int, seconds: float, device="cuda") -> dict:
    """The phases of the module's docstring on one cell; returns the line."""
    import gc

    import torch
    from torch.profiler import ProfilerActivity, profile

    from benchmark.harness import trace as tr
    from benchmark.harness.cell import make_entry, metric_reader
    from benchmark.run import TRACE_PLAIN_SHARE, WARMUP_CALLS, Reservoir, _drive
    from humaniflow_torch.utils import tracing

    entry = make_entry(cell, seed, device)
    for k in range(WARMUP_CALLS):
        entry.call(k)
    tr.sync(device)
    gc.collect()
    gc.freeze()
    nothing = Reservoir(0, random.Random(seed))
    out = {"cell": cell.name, "seed": seed, "seconds": seconds}
    done = 0
    for phase, share, traced in (("plain", TRACE_PLAIN_SHARE, False), ("spans", SPAN_SHARE, True)):
        tracing.reset()
        latencies = []
        with tracing.tracing() if traced else contextlib.nullcontext():
            attempted, failed, window = _drive(entry, seconds * share, done, entry.call, nothing, latencies)
        done += attempted
        out[phase] = {"calls": len(latencies), "failed": failed, "window_s": window,
                      "calls_per_s": len(latencies) / window}
        if traced:
            summary, phase_calls = tracing.summary(), len(latencies)
    out["tracing_cost"] = 1.0 - out["spans"]["calls_per_s"] / out["plain"]["calls_per_s"]

    calls = cell.traffic["profiled_calls"]
    tracing.reset()
    tr.sync(device)
    with tracing.tracing(), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for k in range(calls):
            entry.call(done + k)
        tr.sync(device)
        window = time.perf_counter() - t
    device_trace = tr.DeviceTrace(prof, calls, window)
    table = span_table(Events(prof), summary, calls, summary, phase_calls)
    out.update(table)
    out["profiled"] = {"calls": calls, "window_s": window, "busy_s": device_trace.busy_s}
    out["idle_gaps"] = device_trace.idle_gaps()
    out["readings"] = {name: metric_reader(name)({"trace": device_trace}) for name in READINGS}
    on_card = torch.device(device).type == "cuda"
    out["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated(device)) if on_card else 0
    entry.free()
    return out


READINGS = ("dist_infer_launches", "train_step_launches")  # the per-layer metrics that read the program's spans


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)

    import torch

    from benchmark.harness.cell import load_cell
    from benchmark.run import _cache_dirs, forbidden_modules

    _cache_dirs()
    cell = load_cell(args.workload)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    out = run(cell, args.seed, args.seconds)
    if forbidden_modules():
        print(f"forbidden modules loaded: {forbidden_modules()}", file=sys.stderr)
        return 3
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
