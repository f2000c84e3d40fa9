"""Rotation-representation conversions (6D, axis-angle, matrix).

The PyTorch counterpart of the parts of `humaniflow_tpu/ops/rotation.py`
that distribution inference, evaluation and training use.
"""

import torch

from .so3 import so3_exp, so3_log


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


def aa_rotate_rotmats(rotmats: torch.Tensor, axes, angles, rot_mult_order: str = "post"):
    """Rotate a batch of rotation matrices about axis-angle rotations.

    :param rotmats: (B, 3, 3)
    :param axes: (B, 3) or (3,)
    :param angles: (B, 1) or scalar, radians
    :param rot_mult_order: "post" (rotmats @ R) or "pre" (R @ rotmats)
    :return: (rotated axis-angle (B, 3), rotated rotmats (B, 3, 3))
    """
    if rot_mult_order not in ("pre", "post"):
        raise ValueError(f"rot_mult_order must be 'pre' or 'post', got {rot_mult_order!r}")
    r = torch.as_tensor(axes, dtype=rotmats.dtype, device=rotmats.device) * torch.as_tensor(
        angles, dtype=rotmats.dtype, device=rotmats.device
    )
    if r.dim() < 2:
        r = r[None, :].expand(rotmats.shape[0], 3)
    rot = so3_exp(r)
    out = torch.matmul(rotmats, rot) if rot_mult_order == "post" else torch.matmul(rot, rotmats)
    return so3_log(out), out


def aa_rotate_translate_points(points: torch.Tensor, axes, angles, translations) -> torch.Tensor:
    """Rotate and translate batched point sets.

    :param points: (B, N, 3)
    :param axes: (B, 3) or (3,); :param angles: (B, 1) or scalar
    :param translations: (B, 3) or (3,)
    """
    kw = dict(dtype=points.dtype, device=points.device)
    r = torch.as_tensor(axes, **kw) * torch.as_tensor(angles, **kw)
    if r.dim() < 2:
        r = r[None, :].expand(points.shape[0], 3)
    out = torch.einsum("bij,bkj->bki", so3_exp(r), points)
    return out + torch.as_tensor(translations, **kw).reshape(-1, 1, 3)
