"""The device's idle share of a traced run of a training cell, in %."""

from benchmark.harness.device_metrics import idle_share


def read(run):
    return idle_share(run)
