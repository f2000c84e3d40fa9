"""Training-metric helpers: only what evaluation needs from
`humaniflow_tpu/metrics/train_metrics.py`.  The training tracker waits for
the training slice."""


def undo_keypoint_normalisation(joints2d, img_wh):
    """[-1, 1] normalised keypoints → pixel coordinates."""
    return (joints2d + 1.0) * (img_wh / 2.0)
