"""Evaluation metrics: point-estimate, distribution-accuracy,
sample-consistency and sample-diversity metrics.

The PyTorch counterpart of `humaniflow_tpu/metrics/eval_metrics.py`, with
the same metric names, definitions, mm conversion and per-frame `.npy`
dumps.  `compute_batch_metrics` runs every per-batch reduction on the
batch's device; `EvalMetricsTracker` keeps the running sums there as one
packed float32 vector and fetches them, with the per-frame values, once
every `sync_every` batches.

Metric families:
* point estimates:  PVE[-SC|-PA], PVE-T[-SC], MPJPE[-SC|-PA], joints2D-L2E,
  silhouette-IOU (+ input_* variants scored against the proxy's joints)
* distribution accuracy:  <metric>_samples_min (min over N samples)
* sample-input consistency:  joints2Dsamples-L2E, silhouettesamples-IOU
* sample diversity:  verts3D/joints3D[_vis|_invis]_sample_diversity
"""

import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..data.label_conversions import convert_heatmaps_to_2d_joints_coordinates
from ..ops.alignment import procrustes_analysis_batch, scale_and_translation_transform_batch


def _l2(a, b):
    return torch.linalg.norm(a - b, dim=-1)


def _min_over_samples(err_per_sample):
    """(B, N, P) errors → (B, P) of the sample with the least mean error."""
    best = torch.argmin(err_per_sample.mean(dim=-1), dim=-1)  # (B,)
    return torch.take_along_dim(err_per_sample, best[:, None, None], dim=1)[:, 0]


def _flat_align(align_fn, pred_samples, target):
    """Apply a (B, P, 3)-batched alignment over a samples axis."""
    b, n = pred_samples.shape[:2]
    t = target[:, None].expand(pred_samples.shape)
    out = align_fn(pred_samples.reshape(b * n, *pred_samples.shape[2:]), t.reshape(b * n, *t.shape[2:]))
    return out.reshape(pred_samples.shape), t


def _iou_counts(pred, target):
    pred = pred.to(torch.bool)
    target = target.to(torch.bool)
    dims = tuple(range(1, pred.dim()))
    tp = torch.sum(pred & target, dim=dims)
    fp = torch.sum(pred & ~target, dim=dims)
    fn = torch.sum(~pred & target, dim=dims)
    return tp, fp, fn


def compute_batch_metrics(metrics: Sequence[str], pred: Dict, target: Dict, input_joints2d=None,
                          input_joints2d_vis=None, num_samples: Optional[int] = None):
    """Per-frame metric values and accumulation terms for one batch.

    Returns (per_frame {metric: (B,)}, sums {name: scalar tensor}).
    """
    pf, sums = {}, {}

    def record(name, per_elem):
        """per_elem: (B, P) per-element errors → sum + per-frame mean."""
        sums[name] = torch.sum(per_elem)
        pf[name] = per_elem.mean(dim=-1)

    # ---------------- 3D point estimates
    if "PVE" in metrics:
        record("PVE", _l2(pred["verts3D"], target["verts3D"]))
    if "PVE-SC" in metrics:
        sc = scale_and_translation_transform_batch(pred["verts3D"], target["verts3D"])
        record("PVE-SC", _l2(sc, target["verts3D"]))
    if "PVE-PA" in metrics:
        pa = procrustes_analysis_batch(pred["verts3D"], target["verts3D"])
        record("PVE-PA", _l2(pa, target["verts3D"]))
    if "PVE-T" in metrics:
        record("PVE-T", _l2(pred["tpose_verts3D"], target["tpose_verts3D"]))
    if "PVE-T-SC" in metrics:
        sc = scale_and_translation_transform_batch(pred["tpose_verts3D"], target["tpose_verts3D"])
        record("PVE-T-SC", _l2(sc, target["tpose_verts3D"]))
    if "MPJPE" in metrics:
        record("MPJPE", _l2(pred["joints3D"], target["joints3D"]))
    if "MPJPE-SC" in metrics:
        sc = scale_and_translation_transform_batch(pred["joints3D"], target["joints3D"])
        record("MPJPE-SC", _l2(sc, target["joints3D"]))
    if "MPJPE-PA" in metrics:
        pa = procrustes_analysis_batch(pred["joints3D"], target["joints3D"])
        record("MPJPE-PA", _l2(pa, target["joints3D"]))

    # ---------------- distribution accuracy (min over samples)
    if "PVE_samples_min" in metrics:
        err = _l2(pred["verts3D_samples"], target["verts3D"][:, None])
        record("PVE_samples_min", _min_over_samples(err))
    if "PVE-SC_samples_min" in metrics:
        sc, t = _flat_align(scale_and_translation_transform_batch, pred["verts3D_samples"], target["verts3D"])
        record("PVE-SC_samples_min", _min_over_samples(_l2(sc, t)))
    if "PVE-PA_samples_min" in metrics:
        pa, t = _flat_align(procrustes_analysis_batch, pred["verts3D_samples"], target["verts3D"])
        record("PVE-PA_samples_min", _min_over_samples(_l2(pa, t)))
    if "PVE-T_samples_min" in metrics:
        err = _l2(pred["tpose_verts3D_samples"], target["tpose_verts3D"][:, None])
        record("PVE-T_samples_min", _min_over_samples(err))
    if "PVE-T-SC_samples_min" in metrics:
        sc, t = _flat_align(
            scale_and_translation_transform_batch, pred["tpose_verts3D_samples"], target["tpose_verts3D"]
        )
        record("PVE-T-SC_samples_min", _min_over_samples(_l2(sc, t)))
    if "MPJPE_samples_min" in metrics:
        err = _l2(pred["joints3D_samples"], target["joints3D"][:, None])
        record("MPJPE_samples_min", _min_over_samples(err))
    if "MPJPE-SC_samples_min" in metrics:
        sc, t = _flat_align(scale_and_translation_transform_batch, pred["joints3D_samples"], target["joints3D"])
        record("MPJPE-SC_samples_min", _min_over_samples(_l2(sc, t)))
    if "MPJPE-PA_samples_min" in metrics:
        pa, t = _flat_align(procrustes_analysis_batch, pred["joints3D_samples"], target["joints3D"])
        record("MPJPE-PA_samples_min", _min_over_samples(_l2(pa, t)))

    # ---------------- 2D point estimates and samples
    def vis_masked_2d(name, pred_j2d, tgt_j2d, vis, samples=False):
        err = _l2(pred_j2d, tgt_j2d)  # (B, 17) or (B, N, 17)
        if samples:
            n = err.shape[1]
            err = err * vis[:, None]
            sums[name] = torch.sum(err)
            sums[f"num_vis_{name}"] = torch.sum(vis) * n
            pf[name] = torch.sum(err, dim=(1, 2)) / (torch.sum(vis, dim=-1) * n + 1e-12)
        else:
            err = err * vis
            sums[name] = torch.sum(err)
            sums[f"num_vis_{name}"] = torch.sum(vis)
            pf[name] = torch.sum(err, dim=-1) / (torch.sum(vis, dim=-1) + 1e-12)

    if "joints2D-L2E" in metrics:
        vis = target.get("joints2D_vis")
        if vis is None:
            vis = torch.ones(pred["joints2D"].shape[:-1], device=pred["joints2D"].device)
        vis_masked_2d("joints2D-L2E", pred["joints2D"], target["joints2D"], vis.to(torch.float32))
    if "input_joints2D-L2E" in metrics:
        vis_masked_2d("input_joints2D-L2E", pred["joints2D"], input_joints2d, input_joints2d_vis.to(torch.float32))
    if "joints2Dsamples-L2E" in metrics:
        vis = target.get("joints2D_vis")
        if vis is None:
            s = pred["joints2Dsamples"].shape
            vis = torch.ones((s[0], s[2]), device=pred["joints2Dsamples"].device)
        vis_masked_2d(
            "joints2Dsamples-L2E", pred["joints2Dsamples"], target["joints2D"][:, None],
            vis.to(torch.float32), samples=True,
        )
    if "input_joints2Dsamples-L2E" in metrics:
        vis_masked_2d(
            "input_joints2Dsamples-L2E", pred["joints2Dsamples"], input_joints2d[:, None],
            input_joints2d_vis.to(torch.float32), samples=True,
        )

    # ---------------- silhouettes
    if "silhouette-IOU" in metrics:
        tp, fp, fn = _iou_counts(pred["silhouettes"], target["silhouettes"])
        sums["num_true_positives"] = torch.sum(tp)
        sums["num_false_positives"] = torch.sum(fp)
        sums["num_false_negatives"] = torch.sum(fn)
        pf["silhouette-IOU"] = tp / (tp + fp + fn + 1e-12)
    if "silhouettesamples-IOU" in metrics:
        tp, fp, fn = _iou_counts(pred["silhouettessamples"], target["silhouettes"][:, None])
        sums["num_samples_true_positives"] = torch.sum(tp)
        sums["num_samples_false_positives"] = torch.sum(fp)
        sums["num_samples_false_negatives"] = torch.sum(fn)
        pf["silhouettesamples-IOU"] = tp / (tp + fp + fn + 1e-12)

    # ---------------- sample diversity
    j3d_dist_from_mean = None
    if "verts3D_sample_diversity" in metrics:
        mean = pred["verts3D_samples"].mean(dim=1, keepdim=True)
        d = _l2(pred["verts3D_samples"], mean)  # (B, N, V)
        sums["verts3D_sample_diversity"] = torch.sum(d)
        pf["verts3D_sample_diversity"] = d.mean(dim=(1, 2))
    if "joints3D_sample_diversity" in metrics:
        mean = pred["joints3D_coco_samples"].mean(dim=1, keepdim=True)
        j3d_dist_from_mean = _l2(pred["joints3D_coco_samples"], mean)  # (B, N, 17)
        sums["joints3D_sample_diversity"] = torch.sum(j3d_dist_from_mean)
        pf["joints3D_sample_diversity"] = j3d_dist_from_mean.mean(dim=(1, 2))
    if "joints3D_invis_sample_diversity" in metrics:
        invis = 1.0 - input_joints2d_vis.to(torch.float32)
        d = j3d_dist_from_mean * invis[:, None]
        sums["joints3D_invis_sample_diversity"] = torch.sum(d)
        sums["num_invis_joints3Dsamples"] = torch.sum(invis) * num_samples
        pf["joints3D_invis_sample_diversity"] = d.mean(dim=(1, 2))
    if "joints3D_vis_sample_diversity" in metrics:
        vis = input_joints2d_vis.to(torch.float32)
        d = j3d_dist_from_mean * vis[:, None]
        sums["joints3D_vis_sample_diversity"] = torch.sum(d)
        sums["num_vis_joints3Dsamples"] = torch.sum(vis) * num_samples
        pf["joints3D_vis_sample_diversity"] = d.mean(dim=(1, 2))

    return pf, sums


def _proxy_joints(proxy):
    """Input 2D joints + visibility from the proxy representation (joint
    heatmaps are channels 1..17 of the NHWC proxy)."""
    if proxy is None:
        return None, None
    heatmaps = proxy[..., 1:].permute(0, 3, 1, 2)
    return convert_heatmaps_to_2d_joints_coordinates(heatmaps, gaussian_heatmaps=True)


class EvalMetricsTracker:
    """Accumulator around `compute_batch_metrics`.

    Each batch's sums are added on the device into one packed float32
    vector, and its per-frame values are kept there as one (M_pf, B)
    array; `flush` copies both to the host, which it does every
    `sync_every` batches (1: after every batch).
    """

    def __init__(self, metrics_to_track: Sequence[str], save_path: Optional[str] = None,
                 save_per_frame_metrics: bool = False, num_samples_for_prob_metrics: Optional[int] = None,
                 sync_every: int = 1):
        self.metrics_to_track = tuple(metrics_to_track)
        self.save_path = save_path
        self.save_per_frame_metrics = save_per_frame_metrics
        self.num_samples_for_prob_metrics = num_samples_for_prob_metrics
        self.sync_every = max(int(sync_every), 1)
        self.initialise_metric_sums()
        self.initialise_per_frame_metric_lists()

    def initialise_metric_sums(self):
        self.metric_sums: Dict[str, float] = {}
        self.num_total_test_data = 0
        self._sum_keys = None
        self._pf_keys = None
        self._dev_sums = None
        self._pending_pf = []
        self._batches_since_flush = 0

    def initialise_per_frame_metric_lists(self):
        self.per_frame_metrics = {m: [] for m in self.metrics_to_track}

    @property
    def pending_batches(self) -> int:
        """Batches accumulated on the device since the last flush."""
        return self._batches_since_flush

    def flush(self):
        """Copy the pending sums and per-frame values to the host."""
        if self._dev_sums is not None:
            for k, v in zip(self._sum_keys, self._dev_sums.cpu().tolist()):
                self.metric_sums[k] = self.metric_sums.get(k, 0.0) + float(v)
        for pf in self._pending_pf:
            for k, row in zip(self._pf_keys, pf.cpu().numpy()):
                self.per_frame_metrics[k].append(row)
        self._dev_sums = None
        self._pending_pf = []
        self._batches_since_flush = 0

    def block_pending(self):
        """Wait for the device work behind the pending sums and per-frame
        values without copying them (a timing hook)."""
        if self._dev_sums is not None and self._dev_sums.device.type == "cuda":
            torch.cuda.synchronize(self._dev_sums.device)

    def update_per_batch(self, pred_dict, target_dict, batch_size, model_input=None,
                         return_per_frame_metrics=False):
        self.num_total_test_data += batch_size
        input_j2d, input_vis = _proxy_joints(model_input)
        pf, sums = compute_batch_metrics(
            self.metrics_to_track, pred_dict, target_dict, input_j2d, input_vis,
            self.num_samples_for_prob_metrics,
        )
        if self._sum_keys is None:
            self._sum_keys = tuple(sorted(sums))
            self._pf_keys = tuple(sorted(pf))
        # IOU pixel counts ride in float32 with the other sums, as in the
        # JAX package: each add rounds by at most 6e-8 relative, far below
        # metric resolution.
        svec = torch.stack([sums[k].to(torch.float32) for k in self._sum_keys])
        self._dev_sums = svec if self._dev_sums is None else self._dev_sums + svec
        pfmat = torch.stack([pf[k].to(torch.float32) for k in self._pf_keys]) if self._pf_keys else None
        if pfmat is not None:
            self._pending_pf.append(pfmat)
        self._batches_since_flush += 1
        if return_per_frame_metrics:
            self.flush()
            return {k: self.per_frame_metrics[k][-1] for k in self._pf_keys}
        if self._batches_since_flush >= self.sync_every:
            self.flush()
        return None

    def compute_final_metrics(self, num_verts: int = 6890) -> Dict[str, float]:
        """Final reductions; prints each metric (mm for distances)."""
        self.flush()
        final = {}
        n = self.num_total_test_data
        ns = self.num_samples_for_prob_metrics
        s = self.metric_sums
        for m in self.metrics_to_track:
            mult = 1.0
            if m == "silhouette-IOU":
                final[m] = s["num_true_positives"] / (
                    s["num_true_positives"] + s["num_false_negatives"] + s["num_false_positives"]
                )
            elif m == "silhouettesamples-IOU":
                final[m] = s["num_samples_true_positives"] / (
                    s["num_samples_true_positives"] + s["num_samples_false_negatives"]
                    + s["num_samples_false_positives"]
                )
            elif m in ("joints2D-L2E", "joints2Dsamples-L2E", "input_joints2D-L2E", "input_joints2Dsamples-L2E"):
                final[m] = s[m] / max(s[f"num_vis_{m}"], 1e-12)
            elif m == "verts3D_sample_diversity":
                mult = 1000.0
                final[m] = s[m] / (n * ns * num_verts)
            elif m == "joints3D_sample_diversity":
                mult = 1000.0
                final[m] = s[m] / (n * ns * 17)
            elif m == "joints3D_invis_sample_diversity":
                mult = 1000.0
                denom = s.get("num_invis_joints3Dsamples", 0.0)
                final[m] = s[m] / denom if denom > 0 else 0.0
            elif m == "joints3D_vis_sample_diversity":
                mult = 1000.0
                final[m] = s[m] / s["num_vis_joints3Dsamples"]
            elif "PVE" in m:
                mult = 1000.0
                final[m] = s[m] / (n * num_verts)
            elif "MPJPE" in m:
                mult = 1000.0
                final[m] = s[m] / (n * 14)
            print(m, "{:.2f}".format(final[m] * mult))

        if self.save_per_frame_metrics and self.save_path is not None:
            os.makedirs(self.save_path, exist_ok=True)
            for m in self.metrics_to_track:
                if self.per_frame_metrics[m]:
                    arr = np.concatenate(self.per_frame_metrics[m], axis=0)
                    np.save(os.path.join(self.save_path, m + "_per_frame.npy"), arr)
        return final
