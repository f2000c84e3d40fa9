"""Sample-axis parallelism for distribution inference.

The PyTorch counterpart of `humaniflow_tpu/parallel/sample_parallel.py`.
Distribution inference draws N (≈100) SMPL samples per image and reduces
them to a per-vertex variance; the sample axis is embarrassingly parallel
and, unlike data parallelism, shrinks the latency of a batch.  Over a 2-D
("data", "sample") mesh (rank r at (r // n_sample, r % n_sample)):

* encoder and AR flow: each rank runs its data block of the batch; the ranks
  of one data block all run the same forward, as JAX replicates it over
  "sample";
* the SMPL moments: each rank keeps its block of the N samples, reduces
  them with kernel K1 (`smpl_vertex_moments`) and one all-reduce over
  "sample" sums the per-image (Σx, Σx²).  Moments are sums, so the
  collective is exact;
* every rank ends with the whole batch (an all-gather over "data").

Each rank draws the whole batch's noise and keeps its block, so the result
is that of one process drawing from the same generator.
"""

import torch
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..models.smpl import SMPLModel, smpl_forward, smpl_vertex_moments
from .mesh import DATA_AXIS, _mesh_device_type, all_gather_cat, all_reduce_sum, axis_group, axis_rank, axis_size, \
    shard_batch

SAMPLE_AXIS = "sample"


def make_mesh_2d(n_data: int, n_sample: int) -> DeviceMesh:
    """A (data, sample) mesh over n_data · n_sample ranks, the process group's
    world; rank r sits at (r // n_sample, r % n_sample)."""
    return init_device_mesh(_mesh_device_type(), (n_data, n_sample), mesh_dim_names=(DATA_AXIS, SAMPLE_AXIS))


def make_sharded_inference_fn(model, smpl: SMPLModel, mesh: DeviceMesh, num_samples: int = 100):
    """Distribution inference over a (data, sample) mesh:
    infer(proxy (B, wh, wh, 18), generator=None, base_noise=None) →
    (point-estimate vertices (B, V, 3), per-vertex variance (B, V)), the
    whole batch on every rank.  Every rank passes the same proxy and the
    same generator state (or the whole batch's base noise, per level
    (B, N, P, 3)); B must divide the "data" axis and num_samples the
    "sample" axis."""
    n_sample_shards = axis_size(mesh, SAMPLE_AXIS)
    assert num_samples % n_sample_shards == 0, (
        f"num_samples={num_samples} must divide the sample axis ({n_sample_shards})"
    )
    local_n = num_samples // n_sample_shards
    s = axis_rank(mesh, SAMPLE_AXIS)
    data_group, sample_group = axis_group(mesh, DATA_AXIS), axis_group(mesh, SAMPLE_AXIS)

    @torch.inference_mode()
    def infer(proxy, generator=None, base_noise=None):
        if base_noise is None:
            _, base_noise = model.draw_noise(proxy.shape[0], num_samples, generator, use_shape_mode_for_samples=True)
        proxy, base_noise = shard_batch((proxy, list(base_noise)), mesh)
        out = model.apply(proxy, num_samples=num_samples, use_shape_mode_for_samples=True, base_noise=base_noise)
        lb = proxy.shape[0]
        samples = slice(s * local_n, (s + 1) * local_n)
        mom = smpl_vertex_moments(
            smpl, out["shape_samples"][:, samples].reshape(lb * local_n, -1),
            out["pose_rotmats_samples"][:, samples].reshape(lb * local_n, 23, 3, 3),
            out["glob_rotmat"][:, None].expand(lb, local_n, 3, 3).reshape(lb * local_n, 3, 3), num_groups=lb,
        )
        mom = all_reduce_sum(mom, sample_group)  # the per-image sums over every sample block
        s1, s2 = mom[:, 0] / num_samples, mom[:, 1] / num_samples
        vertex_var = torch.clamp(s2 - s1 * s1, min=0.0).sum(dim=1)  # (B/D, V)
        point_est = smpl_forward(smpl, out["shape_mode"], out["pose_rotmats_point_est"], out["glob_rotmat"])
        return all_gather_cat(point_est["vertices"], data_group), all_gather_cat(vertex_var, data_group)

    return infer
