"""Training loss and metric tracker with epoch history, resume and
best-model selection.

The PyTorch counterpart of `humaniflow_tpu/metrics/train_metrics.py`
(reference metrics/train_loss_and_metrics_tracker.py): the same metric list,
per-epoch reductions, pickled `log.pkl` history, resume-aware truncation and
best-epoch decision.  `batch_sums_device` reduces one batch to a few scalars
on the batch's device with no host sync; the train loop packs them, fetches
them once per epoch and hands each batch's values to `add_batch_sums`.
"""

import pickle
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from .eval_metrics import compute_batch_metrics

ALL_METRICS = [
    "PVE", "PVE-SC", "PVE-PA", "PVE-T", "PVE-T-SC",
    "MPJPE", "MPJPE-SC", "MPJPE-PA",
    "joints2D-L2E", "joints2Dsamples-L2E",
]


def undo_keypoint_normalisation(joints2d, img_wh):
    """[-1, 1] normalised keypoints → pixel coordinates."""
    return (joints2d + 1.0) * (img_wh / 2.0)


def flatten_sums(vals: Dict) -> Tuple[List[str], torch.Tensor]:
    """A batch_sums_device dict → (names, one float32 vector)."""
    names, leaves = [], []
    for k, v in vals.items():
        for name, leaf in (v.items() if isinstance(v, dict) else [(None, v)]):
            names.append(k if name is None else f"{k}/{name}")
            leaves.append(leaf.reshape(()).to(torch.float32))
    return names, torch.stack(leaves)


def unflatten_sums(names: List[str], values) -> Dict:
    """Inverse of flatten_sums on host values."""
    out: Dict = {"sums": {}}
    for name, v in zip(names, values):
        k, _, sub = name.partition("/")
        if sub:
            out.setdefault(k, {})[sub] = float(v)
        else:
            out[k] = float(v)
    return out


class TrainingLossesAndMetricsTracker:
    def __init__(self, metrics_to_track: Sequence[str], img_wh: int, log_save_path: Optional[str] = None,
                 load_logs: bool = False, current_epoch: Optional[int] = None):
        self.metrics_to_track = tuple(metrics_to_track)
        self.img_wh = img_wh
        self.log_save_path = log_save_path
        self.all_metrics_types = [f"{split}_{m}" for m in ALL_METRICS for split in ("train", "val")]
        if load_logs:
            self.epochs_history = self.load_history(log_save_path, current_epoch)
        else:
            self.epochs_history: Dict[str, List[float]] = {"train_losses": [], "val_losses": []}
            for m in self.all_metrics_types:
                self.epochs_history[m] = []
        self.loss_metric_sums = None

    def load_history(self, path, current_epoch):
        """The history truncated to the resume epoch, missing metrics zero-filled."""
        with open(path, "rb") as f:
            history = pickle.load(f)
        history["train_losses"] = history["train_losses"][:current_epoch]
        history["val_losses"] = history["val_losses"][:current_epoch]
        for m in self.all_metrics_types:
            history[m] = history[m][:current_epoch] if m in history else [0.0] * current_epoch
        for key in history:
            assert len(history[key]) == current_epoch
        return history

    def initialise_loss_metric_sums(self):
        self.loss_metric_sums = {"train_losses": 0.0, "val_losses": 0.0, "train_num_samples": 0,
                                 "val_num_samples": 0}
        for m in self.all_metrics_types:
            self.loss_metric_sums[m] = 0.0
        for split in ("train", "val"):
            self.loss_metric_sums[f"{split}_num_visib_joints2Dsamples"] = 0.0

    def batch_sums_device(self, loss, pred_dict, target_dict, pred_tpose_vertices=None,
                          target_tpose_vertices=None) -> Dict:
        """Everything one batch contributes, as scalars on the batch's device.
        Predicted joints2D arrive normalised to [-1, 1] and are taken back to
        pixels here."""
        pred = dict(pred_dict)
        for k in ("joints2D", "joints2Dsamples"):
            if k in pred:
                pred[k] = undo_keypoint_normalisation(pred[k], self.img_wh)
        if pred_tpose_vertices is not None:
            pred["tpose_verts3D"] = pred_tpose_vertices
        target = dict(target_dict)
        if target_tpose_vertices is not None:
            target["tpose_verts3D"] = target_tpose_vertices
        _, sums = compute_batch_metrics(self.metrics_to_track, pred, target)
        out = {"loss": loss, "sums": sums}
        if "joints2D-L2E" in self.metrics_to_track:
            # the reference tracker does not mask the point-estimate 2D error
            # by visibility; sums[...] is masked, so reduce the unmasked one too
            out["j2d_unmasked"] = torch.linalg.norm(pred["joints2D"] - target["joints2D"], dim=-1).sum()
        return out

    def add_batch_sums(self, split: str, host_vals: Dict, batch_size: int):
        """Accumulate one batch's fetched batch_sums_device values."""
        assert split in ("train", "val")
        s = self.loss_metric_sums
        s[f"{split}_losses"] += float(host_vals["loss"]) * batch_size
        s[f"{split}_num_samples"] += batch_size
        sums = host_vals["sums"]
        for m in self.metrics_to_track:
            if m == "joints2Dsamples-L2E":
                s[f"{split}_{m}"] += float(sums[m])
                s[f"{split}_num_visib_joints2Dsamples"] += float(sums["num_vis_joints2Dsamples-L2E"])
            elif m == "joints2D-L2E":
                s[f"{split}_{m}"] += float(host_vals["j2d_unmasked"])
            else:
                s[f"{split}_{m}"] += float(sums[m])

    def update_per_epoch(self):
        h, s = self.epochs_history, self.loss_metric_sums
        h["train_losses"].append(s["train_losses"] / max(s["train_num_samples"], 1))
        h["val_losses"].append(s["val_losses"] / max(s["val_num_samples"], 1))
        for mt in self.all_metrics_types:
            split, metric = mt.split("_", 1)
            if metric not in self.metrics_to_track:
                h[mt].append(0.0)
            elif "joints2Dsamples" in metric:
                h[mt].append(s[mt] / max(s[f"{split}_num_visib_joints2Dsamples"], 1e-12))
            else:
                per = 6890 if "PVE" in metric else 14 if "MPJPE" in metric else 17
                h[mt].append(s[mt] / max(s[f"{split}_num_samples"] * per, 1))
        print("Finished epoch.")
        print("Train Loss: {:.5f}, Val Loss: {:.5f}".format(h["train_losses"][-1], h["val_losses"][-1]))
        for m in self.metrics_to_track:
            print("Train {}: {:.5f}, Val {}: {:.5f}".format(m, h[f"train_{m}"][-1], m, h[f"val_{m}"][-1]))
        if self.log_save_path is not None:
            with open(self.log_save_path, "wb") as f:
                pickle.dump(h, f)

    def determine_save_model_weights_this_epoch(self, save_val_metrics, best_epoch_val_metrics) -> bool:
        return all(self.epochs_history[f"val_{m}"][-1] <= best_epoch_val_metrics[m] for m in save_val_metrics)
