"""The whole training step's share of the chip's float32 peak, in % (see
benchmark/roofline/humaniflow.py::train_step_flops for what is counted)."""

from benchmark.harness.device_metrics import train_mfu


def read(run):
    return train_mfu(run)
