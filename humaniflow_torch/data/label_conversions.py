"""Joint and segmentation label conventions and converters: the counterpart
of `humaniflow_tpu/data/label_conversions.py`."""

import numpy as np
import torch

# Subsets of the 90-joint SMPL superset (models/smpl.py joint layout)
ALL_JOINTS_TO_COCO_MAP = [24, 26, 25, 28, 27, 16, 17, 18, 19, 20, 21, 1, 2, 4, 5, 7, 8]
ALL_JOINTS_TO_H36M_MAP = list(range(73, 90))
H36M_TO_J17 = [6, 5, 4, 1, 2, 3, 16, 15, 14, 11, 12, 13, 8, 10, 0, 7, 9]
H36M_TO_J14 = H36M_TO_J17[:14]
PW3D_JOINTS2D_TO_COCO_MAP = [0, 15, 14, 17, 16, 5, 2, 6, 3, 7, 4, 11, 8, 12, 9, 13, 10]

TWENTYFOUR_PART_SEG_TO_COCO_JOINTS_MAP = {
    19: 7, 21: 7, 20: 8, 22: 8, 4: 9, 3: 10,
    12: 13, 14: 13, 11: 14, 13: 14, 5: 15, 6: 16,
}

# DensePose 24-part → 14-part lookup (index = DensePose class 0..24)
_DP24_TO_14 = np.zeros(25, np.int64)
for _src, _dst in [
    (1, 1), (2, 1), (3, 11), (4, 12), (5, 14), (6, 13), (7, 8), (8, 6),
    (9, 8), (10, 6), (11, 9), (12, 7), (13, 9), (14, 7), (15, 2), (16, 4),
    (17, 2), (18, 4), (19, 3), (20, 5), (21, 3), (22, 5), (23, 10), (24, 10),
]:
    _DP24_TO_14[_src] = _dst


def convert_densepose_seg_to_14part_labels(densepose_seg: torch.Tensor) -> torch.Tensor:
    """24 DensePose part labels (0..24) → 14 part labels, int64."""
    lut = torch.as_tensor(_DP24_TO_14, device=densepose_seg.device)
    return lut[densepose_seg.long()]


def convert_multiclass_to_binary_labels(labels):
    """Non-zero labels → 1, zero → 0, in the labels' dtype (a tensor or a
    numpy array)."""
    if isinstance(labels, np.ndarray):
        return (labels != 0).astype(labels.dtype)
    return (labels != 0).to(labels.dtype)


def convert_2d_joints_to_gaussian_heatmaps(joints2d: torch.Tensor, img_wh: int, std: float = 4.0):
    """Batched Gaussian heatmap synthesis.

    :param joints2d: (B, N, 2) (x=col, y=row) coordinates.
    :return: (B, N, img_wh, img_wh) heatmaps.
    """
    joints2d = joints2d.to(torch.float32)
    grid = torch.arange(img_wh, dtype=torch.float32, device=joints2d.device)
    xx = grid[None, None, None, :]
    yy = grid[None, None, :, None]
    u = joints2d[..., 0, None, None]
    v = joints2d[..., 1, None, None]
    return torch.exp(-(((xx - u) / std) ** 2) / 2 - (((yy - v) / std) ** 2) / 2)


def convert_heatmaps_to_2d_joints_coordinates(heatmaps: torch.Tensor, eps: float = 1e-6,
                                              gaussian_heatmaps: bool = False):
    """Argmax decode of (B, N, H, W) joint heatmaps → ((B, N, 2) coordinates,
    (B, N) visibility); invisible joints get coordinates −1000.  With
    gaussian_heatmaps, a joint is visible only if its peak is within 1e-2 of
    the largest peak in the batch."""
    b, n, h, w = heatmaps.shape
    flat = heatmaps.reshape(b, n, -1)
    max_vals, max_idx = torch.max(flat, dim=-1)
    x = (max_idx % w).to(torch.float32)
    y = torch.floor(max_idx.to(torch.float32) / w)
    joints2d = torch.stack([x, y], dim=-1)
    vis = max_vals > eps
    if gaussian_heatmaps:
        vis = vis & (max_vals > (torch.max(max_vals) - 1e-2))
    joints2d = torch.where(vis[..., None], joints2d, torch.full_like(joints2d, -1000.0))
    return joints2d, vis
