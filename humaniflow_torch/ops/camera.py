"""Camera models of `humaniflow_tpu/ops/camera.py`: the weak-perspective
(scaled orthographic) projection and the pinhole perspective projection."""

import numpy as np
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


def get_intrinsics_matrix(img_width: int, img_height: int, focal_length: float) -> np.ndarray:
    """Pinhole intrinsics with the principal point at the image centre."""
    return np.array(
        [[focal_length, 0.0, img_width / 2.0], [0.0, focal_length, img_height / 2.0], [0.0, 0.0, 1.0]],
        dtype=np.float32,
    )


def perspective_project(points: torch.Tensor, rotation=None, translation=None, cam_K=None, focal_length=None,
                        img_wh=None) -> torch.Tensor:
    """Perspective projection of 3D point sets.

    :param points: (B, N, 3)
    :param rotation: optional (B, 3, 3) camera rotation
    :param translation: optional (B, 3) camera translation
    :param cam_K: (B, 3, 3) or (3, 3) intrinsics; else built from
        focal_length and img_wh.
    :return: (B, N, 2)
    """
    if cam_K is None:
        cam_K = get_intrinsics_matrix(img_wh, img_wh, focal_length)
    cam_K = torch.as_tensor(cam_K, dtype=points.dtype, device=points.device)
    if cam_K.dim() == 2:
        cam_K = cam_K.expand(points.shape[:-2] + (3, 3))
    if rotation is not None:
        points = torch.einsum("...ij,...kj->...ki", rotation, points)
    if translation is not None:
        points = points + translation[..., None, :]
    projected = points / points[..., 2:3]
    projected = torch.einsum("...ij,...kj->...ki", cam_K, projected)
    return projected[..., :2]
