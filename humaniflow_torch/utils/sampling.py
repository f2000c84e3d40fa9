"""Sample post-processing: per-vertex uncertainty from mesh samples and the
J2D-error-sorted sample selection (the counterpart of
`humaniflow_tpu/utils/sampling.py` but for its uniform SO(3) sampling)."""

import math

import torch

from ..data.label_conversions import ALL_JOINTS_TO_COCO_MAP, convert_heatmaps_to_2d_joints_coordinates
from ..metrics.train_metrics import undo_keypoint_normalisation
from ..ops.camera import orthographic_project
from ..ops.so3 import so3_exp


def compute_vertex_variance_from_samples(vertices_samples: torch.Tensor):
    """Per-vertex uncertainty from mesh samples.

    :param vertices_samples: (N, V, 3) or (B, N, V, 3)
    :return: (avg_l2_from_mean (V,), directional_std (V, 3)), with the batch
        axis if one was given.
    """
    mean = vertices_samples.mean(dim=-3, keepdim=True)
    diff = vertices_samples - mean
    directional_std = torch.sqrt(torch.mean(diff**2, dim=-3))
    avg_l2 = torch.mean(torch.linalg.norm(diff, dim=-1), dim=-2)
    return avg_l2, directional_std


def joints2d_error_sorted_verts_sampling(pred_vertices_samples: torch.Tensor, pred_joints_samples: torch.Tensor,
                                         input_joints2d_heatmaps: torch.Tensor, pred_cam_wp: torch.Tensor):
    """Mesh samples sorted by their largest 2D reprojection error over the
    visible input joints, smallest first (a stable sort: tied errors keep the
    sample order).

    :param pred_vertices_samples: (N, V, 3); :param pred_joints_samples:
        (N, 90, 3); :param input_joints2d_heatmaps: (1, 17, H, W), W the
        image size; :param pred_cam_wp: (1, 3).
    """
    img_wh = input_joints2d_heatmaps.shape[-1]
    joints = pred_joints_samples[:, ALL_JOINTS_TO_COCO_MAP]
    # the x-axis π flip of the camera convention
    flip = so3_exp(torch.tensor([[math.pi, 0.0, 0.0]], dtype=joints.dtype, device=joints.device))[0]
    joints = torch.einsum("ij,nkj->nki", flip, joints)
    j2d = undo_keypoint_normalisation(orthographic_project(joints, pred_cam_wp.expand(joints.shape[0], 3)), img_wh)
    input_j2d, input_vis = convert_heatmaps_to_2d_joints_coordinates(input_joints2d_heatmaps, eps=1e-6)
    err = torch.linalg.norm(j2d - input_j2d[0][None], dim=-1)  # (N, 17)
    # the maximum over visible joints: invisible ones never win
    err = torch.where(input_vis[0][None], err, -math.inf)
    order = torch.argsort(err.amax(dim=-1), stable=True)
    return pred_vertices_samples[order]
