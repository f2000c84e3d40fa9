from .eval_metrics import EvalMetricsTracker, compute_batch_metrics
from .train_metrics import undo_keypoint_normalisation

__all__ = ["EvalMetricsTracker", "compute_batch_metrics", "undo_keypoint_normalisation"]
