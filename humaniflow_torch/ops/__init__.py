from .alignment import procrustes_analysis_batch, scale_and_translation_transform_batch
from .camera import orthographic_project, perspective_project
from .rotation import aa_rotate_rotmats, aa_rotate_translate_points, batch_rodrigues, rot6d_to_rotmat, rotmat_to_rot6d
from .so3 import (
    sinc,
    so3_exp,
    so3_hat,
    so3_log,
    so3_log_abs_det_jacobian,
    so3_vee,
    so3_xset,
)

__all__ = [
    "aa_rotate_rotmats",
    "aa_rotate_translate_points",
    "batch_rodrigues",
    "orthographic_project",
    "perspective_project",
    "procrustes_analysis_batch",
    "rot6d_to_rotmat",
    "rotmat_to_rot6d",
    "scale_and_translation_transform_batch",
    "sinc",
    "so3_exp",
    "so3_hat",
    "so3_log",
    "so3_log_abs_det_jacobian",
    "so3_vee",
    "so3_xset",
]
