"""Kernel K4 (`face_bands_kernel` and `raster_kernel`, one launch a
synthetic batch) against its roofline, in %: the profiled launches' bound
(benchmark/roofline/k4.py, at B meshes of the configuration's proxy size)
over the sum of their two kernels' device times.  A trace with another
count of launches than one of each kernel a call gives nothing."""

from benchmark.harness.cell import roofline


def read(run):
    t = run["trace"]
    if t is None:
        return None
    k4 = roofline("k4")
    us = {k: t.kernel_us(lambda name, k=k: k in name) for k in k4.KERNELS}
    if any(len(v) != t.calls for v in us.values()):
        return None
    b, size = run["cell"].traffic["batch"], run["cell"].config["DATA"]["PROXY_REP_SIZE"]
    return 100.0 * t.calls * k4.launch_bound_s(b, size) / (sum(sum(v) for v in us.values()) / 1e6)
