"""Host-clock ms of the layer's span a call, averaged over the traced window
(benchmark/harness/predict.py opens the span at the layer's public entry and
closes it after a device synchronise)."""


def read(run):
    return run["spans"].mean_ms("proxy_ms")
