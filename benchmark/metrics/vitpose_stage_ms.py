"""Host-clock ms of the keypoint stage's span a call, averaged over the
traced window (benchmark/harness/predict_vitpose.py opens the span at
`predict_hrnet_batch` with the ViTPose net and closes it after a device
synchronise)."""


def read(run):
    return run["spans"].mean_ms("vitpose_stage_ms")
