"""Joint label conventions and converters: the parts of `humaniflow_tpu/data/
label_conversions.py` that the proxy representation and evaluation need."""

import torch

# Subsets of the 90-joint SMPL superset (models/smpl.py joint layout)
ALL_JOINTS_TO_COCO_MAP = [24, 26, 25, 28, 27, 16, 17, 18, 19, 20, 21, 1, 2, 4, 5, 7, 8]
ALL_JOINTS_TO_H36M_MAP = list(range(73, 90))
H36M_TO_J17 = [6, 5, 4, 1, 2, 3, 16, 15, 14, 11, 12, 13, 8, 10, 0, 7, 9]
H36M_TO_J14 = H36M_TO_J17[:14]
PW3D_JOINTS2D_TO_COCO_MAP = [0, 15, 14, 17, 16, 5, 2, 6, 3, 7, 4, 11, 8, 12, 9, 13, 10]


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
