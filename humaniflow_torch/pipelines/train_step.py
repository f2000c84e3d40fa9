"""Training step: teacher-forced forward → loss → backward → Adam, with the
NaN rollback.

The PyTorch counterpart of `humaniflow_tpu/pipelines/train_step.py`.  The
JAX step is a pure function of (params, opt_state); here the step updates
the model's parameters, the optimizer's state and the encoder's BatchNorm
running statistics in place.  When the loss or the global gradient norm is
not finite, all three are left exactly as they were (the BatchNorm
statistics, which the forward updates, are restored from a copy taken before
it), and the step reports nan_skipped = 1.  That decision costs one host
sync per step.  With flow BatchNorm layers, a step that is taken then moves
their running statistics (which are parameters, stepped by the optimizer
first) from the targets and the forward's teacher-forced contexts, as the
JAX step does; a skipped step leaves them too.

SMPL runs through kernel K2 with its gradient (models/cuda_lbs.py
`SMPLVerts`), so the joints-2D loss reaches the shape and the sampled
rotations.  The fused flow level K5 has no backward: the step's forward runs
under grad mode, so its flow runs eager, and only the validation call (no
grad) takes K5.

Data parallel (a device mesh): each rank steps on its block of the batch, as
JAX's GSPMD run does on one global batch.  The encoder's and the flow's
BatchNorm statistics and the visible-joint count of the loss are the whole
batch's (collectives over "data"), each rank takes its block of the whole
batch's noise, and after the backward one all-reduce averages the flat
gradient together with the loss terms, so that the norm, the finiteness gate
and Adam decide the same on every rank.  No DDP wrapper: it would need
find_unused_parameters for the flow BatchNorm's parameters and would hide
the order of the collectives.
"""

import contextlib
from typing import Dict, List, Optional

import torch

from ..configs.defaults import LossConfig
from ..data.label_conversions import ALL_JOINTS_TO_COCO_MAP, ALL_JOINTS_TO_H36M_MAP, H36M_TO_J14
from ..flows.autoregressive import FlowBatchNorm
from ..losses.humaniflow_loss import humaniflow_loss
from ..models.humaniflow import HumaniflowModel
from ..models.resnet import BatchNorm, fp32_convolutions
from ..models.smpl import SMPLModel, smpl_forward
from ..ops.camera import orthographic_project
from ..parallel.mesh import DATA_AXIS, all_reduce_sum, axis_group, shard_batch
from ..utils.tracing import span, traced

_H36M_J14 = [ALL_JOINTS_TO_H36M_MAP[i] for i in H36M_TO_J14]


def predict_joints2d(smpl: SMPLModel, shape, pose_rotmats, glob_rotmat, cam_wp):
    """SMPL → COCO joints → weak-perspective projection, for point estimates
    (B, ...) → (B, 17, 2) or samples (B, N, ...) → (B, N, 17, 2)."""
    if pose_rotmats.dim() == 5:
        b, n = pose_rotmats.shape[:2]
        out = smpl_forward(
            smpl, shape.reshape(b * n, -1), pose_rotmats.reshape(b * n, 23, 3, 3),
            glob_rotmat[:, None].expand(b, n, 3, 3).reshape(b * n, 3, 3),
        )
        cam = cam_wp[:, None].expand(b, n, 3).reshape(b * n, 3)
        return orthographic_project(out["joints"][:, ALL_JOINTS_TO_COCO_MAP], cam).reshape(b, n, 17, 2)
    out = smpl_forward(smpl, shape, pose_rotmats, glob_rotmat)
    return orthographic_project(out["joints"][:, ALL_JOINTS_TO_COCO_MAP], cam_wp)


def init_adam_state(optimizer: torch.optim.Adam):
    """Create Adam's state (step 0, zero moments) for every parameter now,
    as optax.adam(...).init does, instead of at the first step: a parameter
    without a gradient is then updated from its moments like every other."""
    for group in optimizer.param_groups:
        for p in group["params"]:
            state = optimizer.state[p]
            if not state:
                state["step"] = torch.tensor(0.0, dtype=torch.float32)
                state["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
                state["exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)


@contextlib.contextmanager
def batch_stats_over(model: torch.nn.Module, group):
    """Within the block, the model's train-mode BatchNorm statistics (the
    encoder's, and the flow BatchNorm update's) are the whole batch's over
    the ranks of `group`."""
    layers = [m for m in model.modules() if isinstance(m, (BatchNorm, FlowBatchNorm))]
    for m in layers:
        m.group = group
    try:
        yield
    finally:
        for m in layers:
            m.group = None


def make_train_step(model: HumaniflowModel, smpl: SMPLModel, loss_cfg: LossConfig, optimizer: torch.optim.Optimizer,
                    img_wh: int = 256, num_j2d_samples: Optional[int] = None, emit_metric_tensors: bool = False,
                    mesh=None):
    """The train step closure `train_step(batch, generator=None, noise=None,
    update=True) -> metrics`.

    batch: proxy (B, H, W, 18), pose_rotmats (B, 23, 3, 3), glob_rotmats
    (B, 3, 3), shape (B, nb), joints2D (B, 17, 2) pixels, joints2D_vis (B, 17).
    noise: (shape noise (B, N, nb), [per-level pose noise (B, N, P, 3)]), the
    standard-normal draws of the JAX step's key_shape / key_pose; without it
    `generator` draws them.  update=False is the validation step: the same
    forward (BatchNorm on batch statistics) and loss, no backward, and every
    piece of state left as it was.

    metrics: the loss terms and "total", "grad_norm" and "nan_skipped" (with
    update), and with emit_metric_tensors "metric_tensors": point-estimate
    and target vertices and joints for the tracker.  All device tensors.

    mesh: a DeviceMesh (parallel/) whose "data" axis splits the batch: each
    rank passes its block (and the generator state of every rank, or its
    block of the noise); the loss terms returned are the whole batch's, the
    metric tensors the rank's rows.
    """
    n_samples = loss_cfg.NUM_J2D_SAMPLES if num_j2d_samples is None else num_j2d_samples
    use_point_est = "point_est" in loss_cfg.J2D_LOSS_ON
    use_samples = "samples" in loss_cfg.J2D_LOSS_ON
    params: List[torch.nn.Parameter] = [p for g in optimizer.param_groups for p in g["params"]]
    if isinstance(optimizer, torch.optim.Adam):
        init_adam_state(optimizer)
    bn_buffers = [b for k, b in model.encoder.named_buffers() if k.endswith(("running_mean", "running_var"))]
    group = None if mesh is None else axis_group(mesh, DATA_AXIS)
    world = 1 if group is None else torch.distributed.get_world_size(group)

    def _metric_tensors(out, batch):
        pe = smpl_forward(smpl, out["shape_mode"], out["pose_rotmats_point_est"], out["glob_rotmat"])
        tgt = smpl_forward(smpl, batch["shape"], batch["pose_rotmats"], batch["glob_rotmats"])
        return {
            "pred_verts3D": pe["vertices"], "target_verts3D": tgt["vertices"],
            "pred_joints3D": pe["joints"][:, _H36M_J14], "target_joints3D": tgt["joints"][:, _H36M_J14],
        }

    def loss_fn(batch, generator, noise):
        shape_noise, base_noise = noise if noise is not None else (None, None)
        out = model.apply(
            batch["proxy"], generator=generator, compute_point_est=use_point_est,
            num_samples=n_samples if use_samples else 0, compute_for_loglik=True,
            shape_for_loglik=batch["shape"], pose_R_for_loglik=batch["pose_rotmats"],
            glob_R_for_loglik=batch["glob_rotmats"], train=True, base_noise=base_noise, shape_noise=shape_noise,
        )
        pose_lp = model.pose_log_prob(batch["pose_rotmats"], out["pose_flow_contexts_for_loglik"])
        j2d_preds = []
        if use_point_est:
            j2d_preds.append(predict_joints2d(smpl, out["shape_mode"], out["pose_rotmats_point_est"],
                                              out["glob_rotmat"], out["cam_wp"])[:, None])
        if use_samples:
            j2d_preds.append(predict_joints2d(smpl, out["shape_samples"], out["pose_rotmats_samples"],
                                              out["glob_rotmat"], out["cam_wp"]))
        pred = {
            "pose_log_probs": pose_lp, "shape_mode": out["shape_mode"], "shape_log_std": out["shape_log_std"],
            "joints2D": torch.cat(j2d_preds, dim=1), "glob_rotmats": out["glob_rotmat"],
        }
        target = {
            "shape_params": batch["shape"], "joints2D": batch["joints2D"], "joints2D_vis": batch["joints2D_vis"],
            "glob_rotmats": batch["glob_rotmats"],
        }
        total, breakdown = humaniflow_loss(loss_cfg, img_wh, pred, target, group=group)
        metrics = {k: v.detach() for k, v in breakdown.items()}
        if emit_metric_tensors:
            with torch.no_grad():
                mt = _metric_tensors(out, batch)
            mt["pred_joints2D"] = pred["joints2D"][:, 0].detach()
            metrics["metric_tensors"] = mt
        return total, metrics, out["pose_flow_contexts_for_loglik"].detach()

    def mean_over_ranks(metrics, grads=()):
        """The ranks' mean of the loss terms, and of the flat gradient if
        given (copied back into the gradients), in one all-reduce."""
        names = [k for k in metrics if k != "metric_tensors"]
        flat = torch.cat([g.reshape(-1) for g in grads] + [torch.stack([metrics[k] for k in names])])
        flat = all_reduce_sum(flat, group) / world
        off = 0
        views = []
        for g in grads:
            views.append(flat[off:off + g.numel()].view_as(g))
            off += g.numel()
        if grads:
            torch._foreach_copy_(list(grads), views)
        metrics.update(zip(names, flat[off:].unbind()))

    @traced("train_step")
    def step(batch, generator, noise, update):
        if group is not None and noise is None and use_samples:
            # the whole batch's noise, drawn as one process draws it; this rank's block
            shape_noise, base_noise = model.draw_noise(batch["proxy"].shape[0] * world, n_samples, generator, False)
            noise = shard_batch((shape_noise, base_noise), mesh)
        saved_bn = [b.clone() for b in bn_buffers]
        if not update:
            with torch.no_grad(), span("train_step.forward"):
                _, metrics, _ = loss_fn(batch, generator, noise)
                if group is not None:
                    mean_over_ranks(metrics)
            torch._foreach_copy_(bn_buffers, saved_bn)
            return metrics
        optimizer.zero_grad(set_to_none=True)
        with span("train_step.forward"):
            loss, metrics, flow_ctx = loss_fn(batch, generator, noise)
        with span("train_step.backward"):
            with fp32_convolutions():  # the backward's convolutions run here, outside the forward's context
                loss.backward()
        for p in params:  # optax updates every parameter, zero gradients included
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if group is not None:
            mean_over_ranks(metrics, [p.grad for p in params])
            loss = metrics["total"]
        with span("train_step.check"):  # bool(ok) waits for the device
            gnorm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm([p.grad for p in params])))
            ok = torch.isfinite(loss.detach()) & torch.isfinite(gnorm)
            take = bool(ok)
        if take:
            with span("train_step.optimizer"):
                optimizer.step()
                # the flow BatchNorm statistics move from the stepped values, with the forward's contexts
                model.update_pose_flow_batchnorm_stats(batch["pose_rotmats"], flow_ctx)
        else:
            torch._foreach_copy_(bn_buffers, saved_bn)
        metrics["grad_norm"] = gnorm
        metrics["nan_skipped"] = (~ok).to(torch.float32)
        return metrics

    def train_step(batch: Dict, generator: Optional[torch.Generator] = None, noise=None, update: bool = True):
        if group is None:
            return step(batch, generator, noise, update)
        with batch_stats_over(model, group):
            return step(batch, generator, noise, update)

    return train_step
