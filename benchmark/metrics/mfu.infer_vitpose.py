"""The whole uncropped prediction's share of the chip's peak, in %: the
least time for HuManiFlow's counted work at the float32 peak
(benchmark/roofline/humaniflow.py) plus ViTPose's on B crops at the peak of
its configured precision (benchmark/roofline/vitpose.py), over the
host-clock time a call took in the traced window's plain calls."""

from benchmark.harness.cell import roofline


def read(run):
    t = run["trace"]
    cfg = run["cell"].config
    if not run["calls"] or t is None or not t.kernels or "VITPOSE" not in cfg:
        return None
    peaks, traffic, vp = roofline("peaks"), run["cell"].traffic, cfg["VITPOSE"]
    b = traffic["batch"]
    t_min = roofline("humaniflow").predict_flops(cfg, b, traffic["num_samples"]) / peaks.FP32_FLOPS
    t_min += b * roofline("vitpose").flops_per_image(vp) / peaks.PEAK_FLOPS[vp["DTYPE"]]
    return 100.0 * t_min / (run["window_s"] / run["calls"])
