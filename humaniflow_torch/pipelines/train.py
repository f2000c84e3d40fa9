"""The training pipeline: synthetic-data generation on the device → train
step → metric tracking → checkpoints, epoch by epoch.

The PyTorch counterpart of `humaniflow_tpu/pipelines/train.py` (reference
train/train_humaniflow.py):

* `make_synth_data_fn` builds one function per batch: SMPL targets, the
  perspective render (kernel K4 with the attribute rasterizer on CUDA),
  crops, augmentations, Canny and heatmaps into the proxy.  Poses, textures
  and backgrounds are its only host inputs; every random number comes from
  one `Draws` source, in the order in which the JAX function uses its keys.
* `train_humaniflow` is the epoch loop: per-step scalar sums stay on the
  device, packed one vector per step, and are fetched once per epoch with
  the render's overflow count; the best parameters are tracked and a
  checkpoint is written every EPOCHS_PER_SAVE epochs, from which a run
  resumes.  On a device mesh each rank trains on its block of every batch
  (the synthetic data's randomness drawn for the whole batch) and rank 0
  writes the files.
"""

import math
import os
from typing import Dict, Optional

import torch
import torch.distributed as dist

from ..configs.defaults import HumaniflowConfig
from ..data.augmentation import (
    Draws,
    augment_cam_t,
    augment_light_colour,
    augment_light_t,
    augment_proxy_representation,
    augment_rgb,
    normal_sample_shape,
    random_extreme_crop,
)
from ..data.image_ops import batch_add_rgb_background, batch_crop_affine
from ..data.joints2d_utils import check_joints2d_occluded, check_joints2d_visibility
from ..data.label_conversions import (
    ALL_JOINTS_TO_COCO_MAP,
    convert_2d_joints_to_gaussian_heatmaps,
    convert_densepose_seg_to_14part_labels,
)
from ..metrics.train_metrics import TrainingLossesAndMetricsTracker, flatten_sums, unflatten_sums
from ..models.canny import CannyEdgeDetector
from ..models.humaniflow import HumaniflowModel
from ..models.smpl import SMPLModel, smpl_forward
from ..ops.camera import perspective_project
from ..ops.rotation import aa_rotate_rotmats, aa_rotate_translate_points
from ..ops.so3 import so3_exp
from ..parallel.mesh import DATA_AXIS, all_reduce_sum, axis_group, axis_rank, axis_size, replicate, shard_batch
from ..utils.checkpoints import load_training_info_from_checkpoint, save_checkpoint
from ..utils.tracing import span, traced
from .train_step import make_train_step


def make_optimizer(model: HumaniflowModel, cfg: HumaniflowConfig) -> torch.optim.Adam:
    """Adam at the reference learning rate with optax.adam's defaults
    (betas 0.9 / 0.999, eps 1e-8, no weight decay)."""
    return torch.optim.Adam(model.parameters(), lr=cfg.TRAIN.LR, betas=(0.9, 0.999), eps=1e-8)


def make_training_renderer(cfg: HumaniflowConfig, cull: bool = True, device=None):
    """The renderer of the synthetic-data batch (scripts/run_train.py:78-103):
    perspective at cfg.TRAIN.SYNTH_DATA.FOCAL_LENGTH and
    cfg.DATA.PROXY_REP_SIZE², binned (kernel K4 on CUDA), per-face texels and
    no UV planes, back-face culled unless cull=False, with the per-batch
    overflow count.  The JAX renderer's binning capacities (live_cap, k_max)
    have no counterpart: K4 has no capacity."""
    from ..render import TexturedIUVRenderer

    return TexturedIUVRenderer(
        img_wh=cfg.DATA.PROXY_REP_SIZE, projection_type="perspective",
        focal_length=cfg.TRAIN.SYNTH_DATA.FOCAL_LENGTH, rasterizer="binned", texture_sampling="face",
        emit_uv=False, binned_cull=cull, emit_overflow=True, device=device,
    )


def make_synth_data_fn(cfg: HumaniflowConfig, smpl: SMPLModel, renderer):
    """The synthetic-data generator `synth_batch(draws, pose72 (B, 72),
    texture (B, 1200, 800, 3), background (B, wh, wh, 3)) -> batch dict`
    (reference train_humaniflow.py:113-245), on the device of its inputs."""
    sd = cfg.TRAIN.SYNTH_DATA
    aug = sd.AUGMENT
    img_wh = cfg.DATA.PROXY_REP_SIZE
    edge_detector = CannyEdgeDetector(
        non_max_suppression=cfg.DATA.EDGE_NMS, gaussian_filter_std=cfg.DATA.EDGE_GAUSSIAN_STD,
        gaussian_filter_size=cfg.DATA.EDGE_GAUSSIAN_SIZE, threshold=cfg.DATA.EDGE_THRESHOLD,
    )
    nb = cfg.MODEL.NUM_SMPL_BETAS

    @torch.no_grad()
    @traced("synth")
    def synth_batch(draws: Draws, pose72, texture, background) -> Dict[str, torch.Tensor]:
        b, dev = pose72.shape[0], pose72.device
        x_axis = torch.tensor([1.0, 0.0, 0.0], device=dev)
        zero3 = torch.zeros(3, device=dev)

        # random pose/shape/camera targets
        pose_r24 = so3_exp(pose72.reshape(b, 24, 3))
        body_r = pose_r24[:, 1:]
        # x-axis π post-flip so that the targets are y-up in 3D
        _, glob_r = aa_rotate_rotmats(pose_r24[:, 0], x_axis, math.pi, rot_mult_order="post")
        shape = normal_sample_shape(draws, b, torch.zeros(nb, device=dev),
                                    torch.full((nb,), aug.SMPL.SHAPE_STD, device=dev))
        cam_t = augment_cam_t(draws, torch.tensor(sd.MEAN_CAM_T, device=dev).expand(b, 3),
                              xy_std=aug.CAM.XY_STD, delta_z_range=aug.CAM.DELTA_Z_RANGE)
        with span("synth.smpl"):
            smpl_out = smpl_forward(smpl, shape, body_r, glob_r)

        # render + 2D targets
        verts_render = aa_rotate_translate_points(smpl_out["vertices"], x_axis, math.pi, zero3)
        joints_coco = aa_rotate_translate_points(smpl_out["joints"][:, ALL_JOINTS_TO_COCO_MAP], x_axis, math.pi,
                                                 zero3)
        j2d = perspective_project(joints_coco, None, cam_t, focal_length=sd.FOCAL_LENGTH, img_wh=img_wh)
        j2d_vis = check_joints2d_visibility(j2d, img_wh)
        # one light for the whole batch: drawn whole on every rank of a data-parallel run
        lights = augment_light_colour(
            draws.whole(), 1, ambient_intensity_range=aug.RGB.LIGHT_AMBIENT_RANGE,
            diffuse_intensity_range=aug.RGB.LIGHT_DIFFUSE_RANGE,
            specular_intensity_range=aug.RGB.LIGHT_SPECULAR_RANGE,
        )
        lights["location"] = augment_light_t(draws.whole(), 1, aug.RGB.LIGHT_LOC_RANGE)
        with span("synth.render"):
            render = renderer(verts_render, cam_t=cam_t, textures=texture, lights_rgb_settings=lights)
            iuv, rgb = render["iuv_images"], render["rgb_images"]

        with span("synth.crop"):
            # extreme crop + box crop with jitter
            seg_extreme = random_extreme_crop(draws, iuv[..., 0].to(torch.int32),
                                              extreme_crop_probability=aug.PROXY_REP.EXTREME_CROP_PROB)
            crop = batch_crop_affine(
                (img_wh, img_wh), iuv=iuv, rgb=rgb, joints2d=j2d, bbox_determiner=seg_extreme.to(torch.float32),
                orig_scale_factor=cfg.DATA.BBOX_SCALE_FACTOR, draws=draws,
                delta_scale_range=aug.BBOX.DELTA_SCALE_RANGE, delta_centre_range=aug.BBOX.DELTA_CENTRE_RANGE,
                out_of_frame_pad_val=-1.0,
            )
            iuv, rgb, j2d = crop["iuv"], crop["rgb"], crop["joints2d"]
            seg = torch.round(iuv[..., 0]).to(torch.int32)

        with span("synth.augment"):
            # visibility + occlusion checks
            j2d_vis = check_joints2d_visibility(j2d, img_wh, j2d_vis)
            j2d_vis = check_joints2d_occluded(convert_densepose_seg_to_14part_labels(torch.clamp(seg, min=0)),
                                              j2d_vis)

            # proxy + RGB augmentation
            seg_aug, j2d_input, j2d_vis = augment_proxy_representation(draws, seg, j2d, j2d_vis, aug.PROXY_REP)
            rgb = batch_add_rgb_background(background, rgb, seg_aug)
            rgb, j2d_input, j2d_vis = augment_rgb(draws, rgb, j2d_input, j2d_vis, aug.RGB)

        with span("synth.proxy"):
            # edges + heatmaps → proxy
            edges = edge_detector(rgb)
            edge_in = edges["thresholded_thin_edges"] if cfg.DATA.EDGE_NMS else edges["thresholded_grad_magnitude"]
            heatmaps = convert_2d_joints_to_gaussian_heatmaps(j2d_input, img_wh, std=cfg.DATA.HEATMAP_GAUSSIAN_STD)
            heatmaps = heatmaps * j2d_vis.to(torch.float32)[:, :, None, None]
        out = {
            "proxy": torch.cat([edge_in, heatmaps.permute(0, 2, 3, 1)], dim=-1),
            "pose_rotmats": body_r,
            "glob_rotmats": glob_r,
            "shape": shape,
            "joints2D": j2d,
            "joints2D_vis": j2d_vis.to(torch.float32),
            "rgb_in": rgb,
        }
        if "binning_overflow" in render:
            out["binning_overflow"] = render["binning_overflow"]
        return out

    return synth_batch


def train_humaniflow(
    model: HumaniflowModel,
    smpl: SMPLModel,
    cfg: HumaniflowConfig,
    renderer,
    train_dataset,
    val_dataset,
    experiment_dir: str,
    optimizer: Optional[torch.optim.Optimizer] = None,
    metrics_to_track=("PVE-SC", "joints2D-L2E"),
    save_val_metrics=("PVE-SC",),
    resume_state: Optional[Dict] = None,
    num_epochs: Optional[int] = None,
    steps_per_epoch: Optional[int] = None,
    generator: Optional[torch.Generator] = None,
    mesh=None,
):
    """The epoch loop (reference train_humaniflow.py:94-407) on the model's
    device.  The datasets' `epoch_batches(batch_size)` yield dicts of pose
    (B, 72), texture (B, 1200, 800, 3) and background (B, wh, wh, 3), numpy
    arrays or tensors (tensors already on the device are used as they are).
    `generator` (on the model's device, seed 0 if None) draws every random
    number of the run.  resume_state is a checkpoint dict
    (utils/checkpoints.py::load_checkpoint).

    mesh: a DeviceMesh (parallel/) on whose "data" axis the batch is split;
    every rank calls this with the same datasets and generator state.  The
    model and the optimizer's state are broadcast from rank 0, each rank
    takes its block of every host batch, and only rank 0 writes checkpoints
    and log.pkl.  Raises ValueError if TRAIN.BATCH_SIZE does not divide the
    mesh's device count.

    :return: (the model's final state_dict, the best epoch's state_dict).
    """
    os.makedirs(experiment_dir, exist_ok=True)
    device = model.device
    if generator is None:
        generator = torch.Generator(device).manual_seed(0)
    shard, is_root = None, True
    if mesh is not None:
        n_dev = mesh.size()
        if bsz_check := (cfg.TRAIN.BATCH_SIZE % n_dev):
            raise ValueError(
                f"TRAIN.BATCH_SIZE={cfg.TRAIN.BATCH_SIZE} must divide the "
                f"mesh device count {n_dev} (remainder {bsz_check})"
            )
        shard, is_root = (axis_rank(mesh, DATA_AXIS), axis_size(mesh, DATA_AXIS)), dist.get_rank() == 0
    draws = Draws(generator, shard=shard)
    if optimizer is None:
        optimizer = make_optimizer(model, cfg)

    current_epoch, best_epoch = 0, 0
    best_epoch_val_metrics = {m: math.inf for m in save_val_metrics}
    if resume_state is not None:
        current_epoch, best_epoch, best_epoch_val_metrics = load_training_info_from_checkpoint(
            resume_state, save_val_metrics
        )
        model.load_state_dict(resume_state["params"])
        optimizer.load_state_dict(resume_state["opt_state"])

    synth_batch = make_synth_data_fn(cfg, smpl, renderer)
    step = make_train_step(model, smpl, cfg.LOSS, optimizer, img_wh=cfg.DATA.PROXY_REP_SIZE,
                           emit_metric_tensors=bool(metrics_to_track), mesh=mesh)
    if mesh is not None:  # after the step has made Adam's state
        replicate(model, mesh)
        replicate(optimizer, mesh)
    best = model.state_dict() if resume_state is None else resume_state.get("best_params", model.state_dict())
    best_params = {k: v.detach().clone() for k, v in best.items()}
    tracker = TrainingLossesAndMetricsTracker(
        metrics_to_track, cfg.DATA.PROXY_REP_SIZE, log_save_path=os.path.join(experiment_dir, "log.pkl"),
        load_logs=resume_state is not None, current_epoch=current_epoch,
    )
    if not is_root:
        tracker.log_save_path = None  # the history is read on resume, written by rank 0
    n_ranks = 1 if shard is None else shard[1]

    num_epochs = num_epochs or cfg.TRAIN.NUM_EPOCHS
    bsz = cfg.TRAIN.BATCH_SIZE
    for epoch in range(current_epoch, num_epochs):
        tracker.initialise_loss_metric_sums()
        pending = []  # (split, names, packed device vector) per step
        overflow = torch.zeros((), dtype=torch.int64, device=device)
        for split, dataset in (("train", train_dataset), ("val", val_dataset)):
            for step_count, host_batch in enumerate(dataset.epoch_batches(bsz), start=1):
                if mesh is not None:
                    host_batch = shard_batch(host_batch, mesh)
                inputs = [torch.as_tensor(host_batch[k], device=device) for k in ("pose", "texture", "background")]
                batch = synth_batch(draws, *inputs)
                batch.pop("rgb_in")
                ov = batch.pop("binning_overflow", None)
                if ov is not None:
                    overflow += ov
                metrics = step(batch, generator=generator, update=split == "train")
                mt = metrics.pop("metric_tensors", None)
                if mt is not None and metrics_to_track:
                    vals = tracker.batch_sums_device(
                        metrics["total"] / n_ranks,
                        {"verts3D": mt["pred_verts3D"], "joints3D": mt["pred_joints3D"],
                         "joints2D": mt["pred_joints2D"]},
                        {"verts3D": mt["target_verts3D"], "joints3D": mt["target_joints3D"],
                         "joints2D": batch["joints2D"], "joints2D_vis": batch["joints2D_vis"]},
                    )
                else:
                    vals = {"loss": metrics["total"] / n_ranks, "sums": {}}
                pending.append((split, *flatten_sums(vals)))
                if steps_per_epoch is not None and step_count >= steps_per_epoch:
                    break
        if pending:
            # one fetch per epoch: the packed scalars of every step and the overflow count
            flat = torch.cat([vec for _, _, vec in pending] + [overflow.to(torch.float32)[None]])
            if mesh is not None:  # the ranks' sums (each rank's loss is the whole batch's over n_ranks)
                flat = all_reduce_sum(flat, axis_group(mesh, DATA_AXIS))
            flat = flat.cpu().tolist()
            if flat[-1] > 0:
                print(f"WARNING: the synthetic-data render dropped {int(flat[-1])} faces this epoch "
                      f"(vertex indices out of range)")
            off = 0
            for split, names, vec in pending:
                tracker.add_batch_sums(split, unflatten_sums(names, flat[off:off + len(names)]), bsz)
                off += len(names)
        tracker.update_per_epoch()

        if tracker.determine_save_model_weights_this_epoch(save_val_metrics, best_epoch_val_metrics):
            best_epoch = epoch
            for m in save_val_metrics:
                best_epoch_val_metrics[m] = tracker.epochs_history[f"val_{m}"][-1]
            best_params = {k: v.detach().clone() for k, v in model.state_dict().items()}

        if epoch % cfg.TRAIN.EPOCHS_PER_SAVE == 0 and is_root:
            save_checkpoint(experiment_dir, f"epoch_{epoch:06d}", {
                "epoch": epoch,
                "best_epoch": best_epoch,
                "best_epoch_val_metrics": dict(best_epoch_val_metrics),
                "params": model.state_dict(),
                "best_params": best_params,
                "opt_state": optimizer.state_dict(),
            })
    return model.state_dict(), best_params
