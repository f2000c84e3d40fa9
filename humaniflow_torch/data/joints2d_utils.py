"""2D-joint visibility checks: the counterpart of
`humaniflow_tpu/data/joints2d_utils.py` (reference utils/joints2d_utils.py)."""

import torch

JOINT_TO_BODYPART_14 = {7: 3, 8: 5, 9: 12, 10: 11, 13: 7, 14: 9, 15: 14, 16: 13}


def check_joints2d_visibility(joints2d: torch.Tensor, img_wh: int, visibility=None) -> torch.Tensor:
    """Joints (B, K, 2) outside [0, img_wh]² are invisible; (B, K) bool."""
    if visibility is None:
        visibility = torch.ones(joints2d.shape[:2], dtype=torch.bool, device=joints2d.device)
    x, y = joints2d[..., 0], joints2d[..., 1]
    return visibility & (x >= 0) & (x <= img_wh) & (y >= 0) & (y <= img_wh)


def check_joints2d_occluded(seg14part: torch.Tensor, vis: torch.Tensor, pixel_count_threshold: int = 50):
    """Appendage joints whose 14-part body part covers no more than
    pixel_count_threshold pixels of seg14part (B, H, W) are occluded."""
    new_vis = vis.clone()
    for joint, part in JOINT_TO_BODYPART_14.items():
        count = torch.sum(seg14part == part, dim=(1, 2))
        new_vis[:, joint] = vis[:, joint] & (count > pixel_count_threshold)
    return new_vis
