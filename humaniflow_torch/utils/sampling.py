"""Sample post-processing: per-vertex uncertainty from mesh samples (the
part of `humaniflow_tpu/utils/sampling.py` on the inference path)."""

import torch


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
