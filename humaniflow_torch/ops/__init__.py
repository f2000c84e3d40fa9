from .rotation import batch_rodrigues, rot6d_to_rotmat, rotmat_to_rot6d
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
    "batch_rodrigues",
    "rot6d_to_rotmat",
    "rotmat_to_rot6d",
    "sinc",
    "so3_exp",
    "so3_hat",
    "so3_log",
    "so3_log_abs_det_jacobian",
    "so3_vee",
    "so3_xset",
]
