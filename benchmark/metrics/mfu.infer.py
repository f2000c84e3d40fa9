"""The whole prediction's share of the chip's peak, in % (see
benchmark/roofline/humaniflow.py and hrnet.py for what is counted)."""

from benchmark.harness.device_metrics import predict_mfu


def read(run):
    return predict_mfu(run)
