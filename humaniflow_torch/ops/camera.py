"""Camera models: the weak-perspective (scaled orthographic) projection of
`humaniflow_tpu/ops/camera.py`.  The perspective helpers wait for the
training slice."""

import torch


def orthographic_project(points3d: torch.Tensor, cam_params: torch.Tensor) -> torch.Tensor:
    """Scaled orthographic (weak-perspective) projection.

    :param points3d: (B, N, 3)
    :param cam_params: (B, 3) — (scale, trans_x, trans_y)
    :return: (B, N, 2) projected points: s * (xy + t)
    """
    scale = cam_params[..., None, 0:1]
    trans = cam_params[..., None, 1:3]
    return scale * (points3d[..., :2] + trans)
