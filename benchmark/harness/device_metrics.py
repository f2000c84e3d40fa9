"""Shared by the device-trace readers: the idle share and the MFU of a
traced run."""

from benchmark.harness.cell import roofline


def idle_share(run):
    """1 − (the device's busy time a call ÷ the host time a call), in %:
    busy, the union of kernel intervals over the profiled calls; the host
    time, over the window's plain calls, which the profiler does not slow.
    (device.busy_s over device.window_s is the profiled window's share, in
    which the profiler's own host work stretches the gaps.)"""
    t = run["trace"]
    if t is None or not t.kernels or not run["calls"]:
        return None
    return 100.0 * (1.0 - (t.busy_s / t.calls) / (run["window_s"] / run["calls"]))


def predict_mfu(run):
    """The least time the chip could take for a batch's counted work, at the
    peak of each part's configured precision, over the host-clock time a
    batch took in the traced window's plain calls, in %."""
    t = run["trace"]
    if not run["calls"] or t is None or not t.kernels:  # a device share needs a device trace
        return None
    cfg, traffic = run["cell"].config, run["cell"].traffic
    peaks = roofline("peaks")
    b = traffic["batch"]
    t_min = roofline("humaniflow").predict_flops(cfg, b, traffic["num_samples"]) / peaks.FP32_FLOPS
    if "HRNET" in cfg:
        t_min += b * roofline("hrnet").conv_flops(cfg["HRNET"]) / peaks.PEAK_FLOPS[cfg["HRNET"]["DTYPE"]]
    return 100.0 * t_min / (run["window_s"] / run["calls"])


def train_mfu(run):
    """The least time for a training step's counted work at the float32
    peak, over the host-clock time a step took in the traced window, in %."""
    t = run["trace"]
    if not run["calls"] or t is None or not t.kernels:
        return None
    cfg, b = run["cell"].config, run["cell"].traffic["batch"]
    t_min = roofline("humaniflow").train_step_flops(cfg, b) / roofline("peaks").FP32_FLOPS
    return 100.0 * t_min / (run["window_s"] / run["calls"])
