"""Spans on the host clock and the device trace of a traced run.

A span runs from the call into a layer's public entry to a device
synchronise after it.  The device trace is torch.profiler's (CUPTI) over a
fixed number of calls: every kernel's interval, the union of them (busy),
the traced window's length, the kernels by device time and the idle gaps by
the innermost host operation running at each gap's middle.  The busy and
idle arithmetic is the one the program's `utils/profiling.py::device_profile`
uses, kept here so that the yardstick does not move with the program.
"""

import time
from collections import defaultdict
from contextlib import contextmanager

import torch


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Spans:
    """Summed host-clock seconds and counts per span name."""

    def __init__(self, device):
        self.device = device
        self.seconds = defaultdict(float)
        self.count = defaultdict(int)

    @contextmanager
    def __call__(self, name: str):
        t = time.perf_counter()
        yield
        sync(self.device)
        self.seconds[name] += time.perf_counter() - t
        self.count[name] += 1

    def mean_ms(self, name: str):
        n = self.count.get(name, 0)
        return 1e3 * self.seconds[name] / n if n else None


def _union(intervals):
    busy, cur_s, cur_e, gaps = 0.0, None, None, []
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
                gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy, gaps


class DeviceTrace:
    """What one torch.profiler session over `calls` calls recorded.

    kernels: [(name, start_us, end_us)]; window_s: host seconds from the first
    call to the synchronise after the last; busy_s: the union of the kernel
    intervals in seconds."""

    def __init__(self, prof, calls: int, window_s: float):
        kernels, host = [], []
        for e in prof.events():
            if e.time_range.elapsed_us() <= 0:
                continue
            if e.device_type == torch.autograd.DeviceType.CUDA:
                kernels.append((e.name, e.time_range.start, e.time_range.end))
            else:
                host.append((e.name, e.time_range.start, e.time_range.end))
        self.kernels = kernels
        self.calls = calls
        self.window_s = window_s
        busy_us, self._gaps = _union([(s, e) for _, s, e in kernels])
        self.busy_s = busy_us / 1e6
        self._host = host

    def kernel_us(self, match) -> list:
        """Device µs of each kernel whose name satisfies match(name), in launch order."""
        return [e - s for name, s, e in sorted(self.kernels, key=lambda k: k[1]) if match(name)]

    def top_ops(self, top: int = 10) -> list:
        by = defaultdict(float)
        for name, s, e in self.kernels:
            by[name] += (e - s) / 1e6
        return [[n[:120], v] for n, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> list:
        """Idle seconds between kernels, summed by the innermost host
        operation that covers each gap's middle ("(none)" where none does)."""
        import bisect

        host = sorted(self._host, key=lambda h: h[1])
        starts = [h[1] for h in host]
        by = defaultdict(float)
        for s, e in self._gaps:
            mid = 0.5 * (s + e)
            name = "(none)"
            # the latest-starting host operation that still covers mid is the innermost one
            for j in range(bisect.bisect_right(starts, mid) - 1, max(-1, bisect.bisect_right(starts, mid) - 4000), -1):
                if host[j][2] >= mid:
                    name = host[j][0][:120]
                    break
            by[name] += (e - s) / 1e6
        return [[n, v] for n, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]


def profile_calls(fn, calls: int, device) -> DeviceTrace:
    """Run fn(k) for k in range(calls) under torch.profiler (host and device
    activities), ending in a synchronise."""
    from torch.profiler import ProfilerActivity, profile

    sync(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for k in range(calls):
            fn(k)
        sync(device)
        window = time.perf_counter() - t
    return DeviceTrace(prof, calls, window)
