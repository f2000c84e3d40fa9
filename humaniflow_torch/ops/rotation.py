"""Rotation-representation conversions (6D, axis-angle, matrix).

The PyTorch counterpart of the parts of `humaniflow_tpu/ops/rotation.py`
that distribution inference uses.
"""

import torch

from .so3 import so3_exp


def rot6d_to_rotmat(x: torch.Tensor) -> torch.Tensor:
    """6D rotation representation → rotation matrices (Zhou et al. CVPR'19).

    :param x: (..., 6) laid out [R11, R12, R21, R22, R31, R32].
    :return: (..., 3, 3)
    """
    m = x.reshape(x.shape[:-1] + (3, 2))
    a1 = m[..., 0]
    a2 = m[..., 1]
    b1 = a1 / torch.clamp(torch.linalg.norm(a1, dim=-1, keepdim=True), min=1e-12)
    proj = torch.sum(b1 * a2, dim=-1, keepdim=True)
    u2 = a2 - proj * b1
    b2 = u2 / torch.clamp(torch.linalg.norm(u2, dim=-1, keepdim=True), min=1e-12)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-1)


def rotmat_to_rot6d(r: torch.Tensor, stack_columns: bool = False) -> torch.Tensor:
    """Rotation matrices → 6D representation (inverse of rot6d_to_rotmat
    when stack_columns=False)."""
    if stack_columns:
        return torch.cat([r[..., :, 0], r[..., :, 1]], dim=-1)
    return r[..., :, :2].reshape(r.shape[:-2] + (6,))


def batch_rodrigues(axisangle: torch.Tensor) -> torch.Tensor:
    """Axis-angle vectors → rotation matrices."""
    return so3_exp(axisangle)
