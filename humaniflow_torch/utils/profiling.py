"""StageTimer, the counterpart of the JAX package's: wall-clock timing of
named stages, each ending when the device work of its result is done and
each also a span of its name (utils/tracing.py).  Where a program's time
goes on the card is the benchmark's to measure (benchmark/run.py and its
span table); kernels alone are timed by kernel_times.py at the root of the
repository."""

import contextlib
import time
from collections import defaultdict
from typing import Dict

from .tracing import span


def _synchronize_devices_of(result):
    """Wait for the CUDA devices that hold the tensors of `result` (a tensor
    or nested lists, tuples and dicts of them): the port's
    jax.block_until_ready."""
    import torch

    devices, todo = set(), [result]
    while todo:
        x = todo.pop()
        if isinstance(x, torch.Tensor):
            if x.device.type == "cuda":
                devices.add(x.device)
        elif isinstance(x, dict):
            todo.extend(x.values())
        elif isinstance(x, (list, tuple)):
            todo.extend(x)
    for device in devices:
        torch.cuda.synchronize(device)


class StageTimer:
    """Wall-clock timing of named stages, each ending when the device work
    of its result is done (the counterpart of the JAX package's StageTimer).
    Each stage is also a span of its name (utils/tracing.py), the
    synchronise included."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    def _add(self, name: str, seconds: float):
        self.totals[name] += seconds
        self.counts[name] += 1

    @contextlib.contextmanager
    def stage(self, name: str, sync_result=None):
        """Time the block; with sync_result, wait for its tensors' devices
        before the clock stops."""
        with span(name):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                if sync_result is not None:
                    _synchronize_devices_of(sync_result)
                self._add(name, time.perf_counter() - t0)

    def time_stage(self, name: str, fn, *args, **kwargs):
        """fn(*args, **kwargs), timed until the device work of its result is done."""
        with span(name):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            _synchronize_devices_of(out)
            self._add(name, time.perf_counter() - t0)
        return out

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            name: {
                "total_s": self.totals[name],
                "count": self.counts[name],
                "mean_ms": 1000.0 * self.totals[name] / max(self.counts[name], 1),
            }
            for name in self.totals
        }

    def report(self) -> str:
        lines = ["stage timings:"]
        for name, s in sorted(self.summary().items()):
            lines.append(f"  {name:<32} {s['mean_ms']:9.2f} ms/call × {s['count']:<6d} = {s['total_s']:8.2f} s")
        return "\n".join(lines)
