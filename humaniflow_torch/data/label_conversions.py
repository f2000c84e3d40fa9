"""Joint label conversions: the parts of `humaniflow_tpu/data/
label_conversions.py` that the proxy representation needs."""

import torch


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
