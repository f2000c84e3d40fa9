"""HumaniflowLoss: pose NLL + shape NLL + visible-joints2D MSE + glob MSE.

The PyTorch counterpart of `humaniflow_tpu/losses/humaniflow_loss.py`
(reference losses/humaniflow_loss.py): the pose NLL scores all 23 parts at
once, and the visible-joint MSE is MSELoss(mean) over the visible rows
(sum over visible elements / (visible joints · 2)).  Weights and reduction
come from the LossConfig.
"""

import math
from typing import Dict

import torch

from ..configs.defaults import LossConfig


def _masked_mse(pred, target, mask):
    """MSELoss(mean) over the rows of pred / target (..., K, D) that mask
    (..., K) selects."""
    se = torch.sum((pred - target) ** 2, dim=-1)
    count = torch.clamp(torch.sum(mask) * pred.shape[-1], min=1.0)
    return torch.sum(se * mask) / count


def humaniflow_loss(loss_cfg: LossConfig, img_wh: int, pred: Dict, target: Dict):
    """The total training loss and its terms.

    pred: pose_log_probs (B, 23); shape_mode, shape_log_std (B, nb);
      joints2D (B, S, K, 2) in [-1, 1] (point estimate and/or samples on
      axis 1); glob_rotmats (B, 3, 3); verts, joints3D with
      APPLY_POINT_EST_LOSS.
    target: shape_params (B, nb); joints2D (B, K, 2) pixels; joints2D_vis
      (B, K); glob_rotmats (B, 3, 3); verts, joints3D with
      APPLY_POINT_EST_LOSS.
    :return: (total, {term: value, ..., "total": total}).
    """
    b, num_parts = pred["pose_log_probs"].shape
    pose_nll = -torch.sum(pred["pose_log_probs"])
    if loss_cfg.REDUCTION == "mean":
        pose_nll = pose_nll / (b * num_parts)

    mode, log_std = pred["shape_mode"], pred["shape_log_std"]
    lp = -0.5 * ((target["shape_params"] - mode) ** 2) / torch.exp(2.0 * log_std) - log_std - 0.5 * math.log(
        2 * math.pi
    )
    shape_nll = -torch.sum(lp, dim=1)
    shape_nll = torch.mean(shape_nll) if loss_cfg.REDUCTION == "mean" else torch.sum(shape_nll)

    t_j2d = ((2.0 * target["joints2D"]) / img_wh - 1.0)[:, None].expand(pred["joints2D"].shape)
    vis = target["joints2D_vis"][:, None].expand(pred["joints2D"].shape[:-1]).to(torch.float32)
    joints2d_loss = _masked_mse(pred["joints2D"], t_j2d, vis)

    glob_loss = torch.mean((pred["glob_rotmats"] - target["glob_rotmats"]) ** 2)

    w = loss_cfg.WEIGHTS
    total = pose_nll * w.POSE + shape_nll * w.SHAPE + joints2d_loss * w.JOINTS2D + glob_loss * w.GLOB_ROTMATS
    breakdown = {"pose_nll": pose_nll, "shape_nll": shape_nll, "joints2D": joints2d_loss, "glob_rotmats": glob_loss}
    if loss_cfg.APPLY_POINT_EST_LOSS:
        verts_loss = torch.mean((pred["verts"] - target["verts"]) ** 2)
        joints3d_loss = torch.mean((pred["joints3D"] - target["joints3D"]) ** 2)
        total = total + verts_loss * w.VERTS3D + joints3d_loss * w.JOINTS3D
        breakdown["verts3D"] = verts_loss
        breakdown["joints3D"] = joints3d_loss
    breakdown["total"] = total
    return total, breakdown
