"""Batched point-set alignment for the evaluation metrics, and the x-z
ground plane of meshes: the PyTorch counterpart of
`humaniflow_tpu/ops/alignment.py`, in float32 throughout.
XLA code in the reference, so plain PyTorch here (torch.linalg.svd)."""

import torch


def procrustes_analysis_batch(s1: torch.Tensor, s2: torch.Tensor, return_R: bool = False):
    """Batched similarity (scale + rotation + translation) alignment of s1 to s2.

    :param s1: (B, N, 3) source point sets.
    :param s2: (B, N, 3) target point sets.
    :return: aligned s1 (B, N, 3), and the rotations (B, 3, 3) if return_R.
    """
    x1 = s1.transpose(-1, -2)  # (B, 3, N)
    x2 = s2.transpose(-1, -2)
    mu1 = x1.mean(dim=-1, keepdim=True)
    mu2 = x2.mean(dim=-1, keepdim=True)
    x1c = x1 - mu1
    x2c = x2 - mu2

    var1 = torch.sum(x1c**2, dim=(-1, -2))
    k = torch.matmul(x1c, x2c.transpose(-1, -2))  # (B, 3, 3)

    u, _, vh = torch.linalg.svd(k)
    v = vh.transpose(-1, -2)
    # Reflection fix: flip the last singular direction where U·Vᵀ reflects.
    det = torch.linalg.det(torch.matmul(u, vh))
    z = torch.eye(3, dtype=s1.dtype, device=s1.device).expand(k.shape).clone()
    z[..., -1, -1] = torch.sign(det)
    r = torch.matmul(torch.matmul(v, z), u.transpose(-1, -2))

    trace = torch.diagonal(torch.matmul(r, k), dim1=-2, dim2=-1).sum(-1)
    scale = (trace / var1)[..., None, None]
    t = mu2 - scale * torch.matmul(r, mu1)

    s1_hat = (scale * torch.matmul(r, x1) + t).transpose(-1, -2)
    if return_R:
        return s1_hat, r
    return s1_hat


def scale_and_translation_transform_batch(p: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Normalise each mesh in p to zero mean and unit RMS distance, then give
    it the mean and RMS distance of the matching mesh in t.

    :param p: (B, N, 3) meshes to transform; :param t: (B, N, 3) references.
    """
    p_mean = p.mean(dim=-2, keepdim=True)
    p_c = p - p_mean
    p_scale = torch.sqrt(torch.sum(p_c**2, dim=(-2, -1), keepdim=True) / p.shape[-2])
    p_norm = p_c / p_scale

    t_mean = t.mean(dim=-2, keepdim=True)
    t_scale = torch.sqrt(torch.sum((t - t_mean) ** 2, dim=(-2, -1), keepdim=True) / t.shape[-2])
    return p_norm * t_scale + t_mean


def make_xz_ground_plane(vertices: torch.Tensor) -> torch.Tensor:
    """Translate meshes (..., V, 3) so that each one's lowest y coordinate
    lies on the x-z plane."""
    lowest_y = vertices[..., 1].amin(dim=-1, keepdim=True)
    out = vertices.clone()
    out[..., 1] -= lowest_y
    return out
