"""Distribution-aware evaluation on SSP-3D and 3DPW.

The PyTorch counterpart of `humaniflow_tpu/pipelines/evaluate.py`: proxy
construction (Canny edges + heatmaps from the dataset's
keypoints), the N-sample forward, gendered SMPL targets (male forward,
female overwrite by the gender mask), neutral-SMPL predictions (point
estimate, T-pose and every sample, through kernel K2), 2D projections with
the x-flip camera convention, silhouettes through the renderer (kernel K3
on CUDA), `EvalMetricsTracker` accumulation and per-frame `.npy` dumps.  With a
device mesh (parallel/) each rank evaluates its block of every batch and
rank 0 tracks the gathered results.
"""

import math
import os
import queue
import threading
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..configs.defaults import HumaniflowConfig
from ..data.datasets import batch_iterator
from ..data.label_conversions import (
    ALL_JOINTS_TO_COCO_MAP,
    ALL_JOINTS_TO_H36M_MAP,
    H36M_TO_J14,
    convert_2d_joints_to_gaussian_heatmaps,
)
from ..metrics.eval_metrics import EvalMetricsTracker
from ..metrics.train_metrics import undo_keypoint_normalisation
from ..models.canny import CannyEdgeDetector
from ..models.humaniflow import HumaniflowModel
from ..models.smpl import SMPLModel, smpl_forward
from ..ops.camera import orthographic_project
from ..ops.rotation import aa_rotate_rotmats
from ..ops.so3 import so3_exp
from ..parallel.mesh import DATA_AXIS, all_gather_tree, axis_group, axis_size, pad_batch_to_devices, shard_batch
from ..utils.device import resolve_device

_H36M_J14 = [ALL_JOINTS_TO_H36M_MAP[i] for i in H36M_TO_J14]
_DEVICE_KEYS = ("image", "pose", "shape", "is_female", "input_joints2D", "input_joints2D_vis", "heatmaps")


def _flip_x(points):
    """Rotate (..., K, 3) points by π about the x axis."""
    flip = so3_exp(torch.tensor([[math.pi, 0.0, 0.0]], dtype=points.dtype, device=points.device))[0]
    return torch.einsum("ij,...kj->...ki", flip, points)


def make_eval_step(model: HumaniflowModel, smpl_neutral: SMPLModel, smpl_male: SMPLModel,
                   smpl_female: SMPLModel, cfg: HumaniflowConfig, num_pred_samples: int,
                   compute_samples: bool, compute_joints2d: bool, renderer=None):
    """The per-batch eval function: eval_step(batch, noise=None,
    generator=None) → (pred, target, proxy, extra).

    The JAX package's make_eval_step keeps its traced step in a memo and an
    AOT executable cache; nothing is traced here, so each call builds the
    step afresh and needs neither.  `renderer` is accepted for the JAX
    signature and unused, as there: the silhouettes are rendered outside
    the step.

    batch holds device tensors: image (B, wh, wh, 3) uint8 or float in
    [0, 1], pose (B, 72), shape (B, 10), is_female (B,), and either
    input_joints2D (B, 17, 2) + input_joints2D_vis (B, 17) or heatmaps
    (B, 17, wh, wh).  noise = (shape_noise (B, N, 10), level_noise [per
    level (B, N, P, 3)]) feeds HumaniflowModel.apply; without it the
    samples are drawn from generator.
    """
    img_wh = cfg.DATA.PROXY_REP_SIZE
    edge_detector = CannyEdgeDetector(
        non_max_suppression=cfg.DATA.EDGE_NMS,
        gaussian_filter_std=cfg.DATA.EDGE_GAUSSIAN_STD,
        gaussian_filter_size=cfg.DATA.EDGE_GAUSSIAN_SIZE,
        threshold=cfg.DATA.EDGE_THRESHOLD,
    )
    dev = model.device
    coco = torch.tensor(ALL_JOINTS_TO_COCO_MAP, device=dev)
    h36m = torch.tensor(_H36M_J14, device=dev)
    x_axis = torch.tensor([1.0, 0.0, 0.0], device=dev)
    n = num_pred_samples if compute_samples else 0

    def tpose(smpl, betas):
        b = betas.shape[0]
        eye = torch.eye(3, dtype=betas.dtype, device=betas.device)
        return smpl_forward(smpl, betas, eye.expand(b, 23, 3, 3), eye.expand(b, 3, 3))

    @torch.inference_mode()
    def eval_step(batch, noise=None, generator: Optional[torch.Generator] = None):
        image = batch["image"]
        if image.dtype == torch.uint8:
            image = image.to(torch.float32) / 255.0
        b = image.shape[0]
        if "heatmaps" in batch:
            heatmaps = batch["heatmaps"]  # (B, 17, wh, wh)
        else:
            heatmaps = convert_2d_joints_to_gaussian_heatmaps(
                batch["input_joints2D"], img_wh, std=cfg.DATA.HEATMAP_GAUSSIAN_STD
            )
            heatmaps = heatmaps * batch["input_joints2D_vis"].to(torch.float32)[:, :, None, None]
        edges = edge_detector(image)
        edge_img = edges["thresholded_thin_edges"] if cfg.DATA.EDGE_NMS else edges["thresholded_grad_magnitude"]
        proxy = torch.cat([edge_img, heatmaps.permute(0, 2, 3, 1)], dim=-1)  # (B, wh, wh, 18)

        # ---------------- gendered targets, y-up (x-axis π pre-rotation)
        target_shape = batch["shape"]
        pose_r = so3_exp(batch["pose"].reshape(b, 24, 3))
        _, glob_r_flipped = aa_rotate_rotmats(pose_r[:, 0], x_axis, math.pi, rot_mult_order="pre")
        body_r = pose_r[:, 1:]
        female = (batch["is_female"] > 0.5)[:, None, None]
        tm = smpl_forward(smpl_male, target_shape, body_r, glob_r_flipped)
        tf = smpl_forward(smpl_female, target_shape, body_r, glob_r_flipped)
        target = {
            "verts3D": torch.where(female, tf["vertices"], tm["vertices"]),
            "joints3D": torch.where(female, tf["joints"][:, h36m], tm["joints"][:, h36m]),
            "tpose_verts3D": torch.where(
                female, tpose(smpl_female, target_shape)["vertices"], tpose(smpl_male, target_shape)["vertices"]
            ),
        }

        # ---------------- predictions
        shape_noise, level_noise = noise if noise is not None else (None, None)
        out = model.apply(proxy, generator=generator, num_samples=n, base_noise=level_noise, shape_noise=shape_noise)
        pe = smpl_forward(smpl_neutral, out["shape_mode"], out["pose_rotmats_point_est"], out["glob_rotmat"])
        pred = {
            "verts3D": pe["vertices"],
            "joints3D": pe["joints"][:, h36m],
            "tpose_verts3D": tpose(smpl_neutral, out["shape_mode"])["vertices"],
        }
        if compute_joints2d:
            j2d = orthographic_project(_flip_x(pe["joints"][:, coco]), out["cam_wp"])
            pred["joints2D"] = undo_keypoint_normalisation(j2d, img_wh)

        if compute_samples:
            flat_shape = out["shape_samples"].reshape(b * n, -1)
            flat = smpl_forward(
                smpl_neutral, flat_shape, out["pose_rotmats_samples"].reshape(b * n, 23, 3, 3),
                out["glob_rotmat"][:, None].expand(b, n, 3, 3).reshape(b * n, 3, 3),
            )
            nv = flat["vertices"].shape[1]
            pred["verts3D_samples"] = flat["vertices"].reshape(b, n, nv, 3)
            pred["joints3D_samples"] = flat["joints"][:, h36m].reshape(b, n, 14, 3)
            pred["joints3D_coco_samples"] = flat["joints"][:, coco].reshape(b, n, 17, 3)
            pred["tpose_verts3D_samples"] = tpose(smpl_neutral, flat_shape)["vertices"].reshape(b, n, nv, 3)
            if compute_joints2d:
                cam = out["cam_wp"][:, None].expand(b, n, 3).reshape(b * n, 3)
                j2ds = orthographic_project(_flip_x(flat["joints"][:, coco]), cam)
                pred["joints2Dsamples"] = undo_keypoint_normalisation(j2ds, img_wh).reshape(b, n, 17, 2)

        extra = {
            "cam_wp": out["cam_wp"],
            "shape_mode": out["shape_mode"],
            "pose_rotmats_point_est": out["pose_rotmats_point_est"],
            "glob_rotmat": out["glob_rotmat"],
            "verts_flipped_point_est": _flip_x(pe["vertices"]),
        }
        return pred, target, proxy, extra

    return eval_step


@torch.inference_mode()
def _render_sample_silhouettes(renderer, verts_samples, cam_wp, chunk: int = 8):
    """Silhouettes of all (B, N) sample meshes as a (B, N, wh, wh) bool mask,
    plus the summed overflow count (a 0-d device tensor).

    Renders `chunk` samples of every image per call (B·chunk meshes), each
    flipped to the render convention and seen by its image's point-estimate
    camera; chunking bounds the renderer's memory at N = 100.
    """
    b, n, v = verts_samples.shape[:3]
    sils = []
    overflow = torch.zeros((), dtype=torch.int64, device=verts_samples.device)
    for s0 in range(0, n, chunk):
        k = min(chunk, n - s0)
        flat = _flip_x(verts_samples[:, s0 : s0 + k]).reshape(b * k, v, 3)
        cam = cam_wp[:, None].expand(b, k, 3).reshape(b * k, 3)
        mask, ov = renderer.render_silhouette_with_overflow(flat, cam)
        overflow = overflow + ov.sum()
        sils.append(mask.reshape(b, k, *mask.shape[1:]).to(torch.bool))
    return torch.cat(sils, dim=1), overflow


def _assemble_host_batch(batch):
    """Host-only batch assembly (numpy): the gender mask and the file names
    split off."""
    b = batch["image"].shape[0]
    genders = batch.pop("gender", ["n"] * b)
    fnames = batch.pop("fname", [""] * b)
    batch["is_female"] = np.array([1.0 if g.startswith("f") else 0.0 for g in genders], np.float32)
    return {"b": b, "fnames": fnames, "batch": batch}


def _prefetched(iterator, depth: int = 2):
    """Run `iterator` on a daemon worker thread with a bounded queue, so that
    host batch assembly (file IO, decode, crops, stacking) overlaps the main
    thread's device work.  Exceptions reach the consumer."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    done = object()

    def worker():
        try:
            for item in iterator:
                q.put(item)
        except BaseException as e:  # handed to the consumer, which re-raises it
            q.put(e)
        q.put(done)

    threading.Thread(target=worker, daemon=True).start()
    while True:
        item = q.get()
        if item is done:
            return
        if isinstance(item, BaseException):
            raise item
        yield item


def _check_device(name: str, dev: torch.device, device: torch.device):
    if dev.type != device.type or (device.index is not None and dev.index != device.index):
        raise ValueError(f"{name} lives on {dev}, not on {device}")


def evaluate_humaniflow(
    model: HumaniflowModel,
    smpl_neutral: SMPLModel,
    smpl_male: SMPLModel,
    smpl_female: SMPLModel,
    cfg: HumaniflowConfig,
    eval_dataset,
    metrics: Sequence[str],
    batch_size: int = 32,
    num_pred_samples: int = 10,
    save_path: Optional[str] = None,
    save_per_frame_metrics: bool = False,
    renderer=None,
    generator: Optional[torch.Generator] = None,
    noise_fn: Optional[Callable] = None,
    silhouette_sample_chunk: int = 8,
    batch_times: Optional[list] = None,
    sync_every: int = 8,
    prefetch: bool = True,
    pre_stage: bool = False,
    device=None,
    mesh=None,
):
    """Full evaluation loop; returns the final metrics {name: float}.

    :param renderer: a TexturedIUVRenderer, needed for the silhouette
        metrics (which are skipped without it, or without target
        silhouettes in the dataset).
    :param generator: draws the sampling noise; default a generator on
        `device` seeded with 0.
    :param noise_fn: noise_fn(batch_index, b, n) → (shape_noise (b, n, 10),
        level_noise [per depth level (b, n, P, 3)]), standard normal; used
        instead of the generator (tests feed the JAX package's draws).
    :param batch_times: per-batch wall seconds are appended (the first
        includes warm-up).  Most batches end without a host sync, so the
        steady-state throughput is (batches − 1) / sum(times[1:]); the last
        entry includes the final drain of the device.
    :param sync_every: device→host copy cadence of the tracker in batches;
        the silhouette overflow count is read on the same cadence.
    :param prefetch: assemble batch i+1 on a worker thread while the device
        runs batch i (host work only).
    :param pre_stage: copy the whole dataset to the device before the loop,
        so that the loop's times exclude host→device copies.
    :param device: default CUDA; raises if CUDA is unavailable.  The model,
        the SMPL models and the renderer must live there.
    :param mesh: optional DeviceMesh (parallel/), on which every rank calls
        this with the same dataset and noise: each batch is padded with zeros
        to the "data" axis and sharded over it, each rank runs the eval step
        and renders the silhouettes (K3) of its block, with its block of the
        whole batch's noise, and the blocks are gathered in frame order and
        trimmed to the batch for rank 0's tracker.  Rank 0 alone writes
        files; every rank returns rank 0's final metrics.
    """
    device = resolve_device(device)
    for name, obj in (("model", model), ("smpl_neutral", smpl_neutral), ("smpl_male", smpl_male),
                      ("smpl_female", smpl_female), ("renderer", renderer)):
        if obj is not None:
            _check_device(name, torch.device(obj.device), device)

    compute_samples = any("sample" in m for m in metrics)
    compute_joints2d = any("joints2D" in m for m in metrics)
    compute_silhouettes = any("silhouette" in m for m in metrics)
    compute_sil_samples = any("silhouettesamples" in m for m in metrics)

    eval_step = make_eval_step(
        model, smpl_neutral, smpl_male, smpl_female, cfg, num_pred_samples, compute_samples, compute_joints2d,
    )
    is_root = mesh is None or dist.get_rank() == 0
    tracker = EvalMetricsTracker(
        metrics, save_path=save_path if is_root else None, save_per_frame_metrics=save_per_frame_metrics and is_root,
        num_samples_for_prob_metrics=num_pred_samples if compute_samples else None, sync_every=sync_every,
    )
    if generator is None and noise_fn is None:
        generator = torch.Generator(device).manual_seed(0)

    fname_list, pose_list, shape_list, cam_list = [], [], [], []
    sil_overflow_total = 0
    sil_overflow_warned = False
    sil_overflow_pending = None  # device-side count between tracker flushes

    def put(v):
        if v is None:
            return None
        if isinstance(v, torch.Tensor):
            return v.to(device)
        return torch.as_tensor(np.asarray(v), device=device)

    def prepare(assembled):
        """Device copies of one host-assembled batch."""
        batch = assembled["batch"]
        return {
            "b": assembled["b"],
            "fnames": assembled["fnames"],
            "dev_batch": {k: put(v) for k, v in batch.items() if k in _DEVICE_KEYS},
            "joints2D": put(batch.get("joints2D")),
            "joints2D_visib": put(batch.get("joints2D_visib")),
            "silhouette": put(batch.get("silhouette")),
        }

    assembled_batches = (_assemble_host_batch(b) for b in batch_iterator(eval_dataset, batch_size))
    if prefetch:
        assembled_batches = _prefetched(assembled_batches)
    if pre_stage:
        source = [prepare(a) for a in assembled_batches]
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    else:
        source = assembled_batches

    for batch_index, item in enumerate(source):
        t0 = time.perf_counter()
        prepared = item if pre_stage else prepare(item)
        b = prepared["b"]
        noise = None
        if noise_fn is not None:
            shape_noise, level_noise = noise_fn(batch_index, b, num_pred_samples)
            noise = (put(shape_noise), [put(z) for z in level_noise])
        dev_batch = prepared["dev_batch"]
        if mesh is not None:
            # the whole batch's noise, padded with the batch; this rank's block of both
            if noise is None and compute_samples:
                noise = model.draw_noise(b, num_pred_samples, generator, use_shape_mode_for_samples=False)
            (dev_batch, noise), _ = pad_batch_to_devices((dev_batch, noise), axis_size(mesh, DATA_AXIS))
            dev_batch, noise = shard_batch((dev_batch, noise), mesh)
        pred, target, proxy, extra = eval_step(dev_batch, noise=noise, generator=generator)

        render_silhouettes = compute_silhouettes and renderer is not None and prepared["silhouette"] is not None
        if render_silhouettes:
            with torch.inference_mode():
                sil, ov = renderer.render_silhouette_with_overflow(extra["verts_flipped_point_est"], extra["cam_wp"])
            overflow_batch = ov.sum()
            pred["silhouettes"] = sil
            if compute_sil_samples and compute_samples:
                # every one of the B·N samples, seen by its image's
                # point-estimate camera
                pred["silhouettessamples"], ov_s = _render_sample_silhouettes(
                    renderer, pred["verts3D_samples"], extra["cam_wp"], chunk=silhouette_sample_chunk,
                )
                overflow_batch = overflow_batch + ov_s
        if mesh is not None:
            # the ranks' blocks in frame order, the padded rows dropped (as JAX: trim, then accumulate)
            pred, target, proxy, extra, overflow = all_gather_tree(
                (pred, target, proxy, extra, overflow_batch[None] if render_silhouettes else None),
                axis_group(mesh, DATA_AXIS),
            )
            pred, target, extra = ({k: v[:b] for k, v in t.items()} for t in (pred, target, extra))
            proxy = proxy[:b]
            if render_silhouettes:
                overflow_batch = overflow.sum()
        if render_silhouettes and is_root:
            target["silhouettes"] = prepared["silhouette"]
            sil_overflow_pending = (
                overflow_batch if sil_overflow_pending is None else sil_overflow_pending + overflow_batch
            )
        if compute_joints2d and prepared["joints2D"] is not None:
            target["joints2D"] = prepared["joints2D"]
            if prepared["joints2D_visib"] is not None:
                target["joints2D_vis"] = prepared["joints2D_visib"]

        if is_root:
            with torch.inference_mode():
                tracker.update_per_batch(pred, target, b, model_input=proxy)
        if tracker.pending_batches == 0 and sil_overflow_pending is not None:
            # the tracker has just copied to the host: read the count too
            ov = int(sil_overflow_pending)
            sil_overflow_pending = None
            sil_overflow_total += ov
            if ov > 0 and not sil_overflow_warned:
                sil_overflow_warned = True
                print(
                    f"WARNING: the silhouette renderer dropped {ov} faces in recent batches; the IOU "
                    "metrics deviate from the exact scan.  Re-run with "
                    "TexturedIUVRenderer(silhouette_exact=True)."
                )
        if batch_times is not None:
            batch_times.append(time.perf_counter() - t0)
        if save_per_frame_metrics and is_root:
            fname_list.extend(prepared["fnames"])
            pose_list.append(extra["pose_rotmats_point_est"])
            shape_list.append(extra["shape_mode"])
            cam_list.append(extra["cam_wp"])

    if batch_times:
        # the last window's device work belongs to the timed loop
        t0 = time.perf_counter()
        tracker.block_pending()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        batch_times[-1] += time.perf_counter() - t0

    if sil_overflow_pending is not None:
        sil_overflow_total += int(sil_overflow_pending)
    if compute_silhouettes and renderer is not None and sil_overflow_total > 0:
        print(
            f"WARNING: the silhouette renderer dropped {sil_overflow_total} faces over the run; the "
            "silhouette IOU metrics deviate from the exact scan.  Re-run with "
            "TexturedIUVRenderer(silhouette_exact=True)."
        )

    if not is_root:
        final = [None]
        dist.broadcast_object_list(final, src=0)
        return final[0]
    final_metrics = tracker.compute_final_metrics(num_verts=smpl_neutral.num_verts)
    if mesh is not None:
        dist.broadcast_object_list([final_metrics], src=0)

    if save_per_frame_metrics and save_path is not None:
        os.makedirs(save_path, exist_ok=True)
        np.save(os.path.join(save_path, "fname_per_frame.npy"), np.array(fname_list))
        for name, parts in (("pose", pose_list), ("shape", shape_list), ("cam", cam_list)):
            np.save(os.path.join(save_path, f"{name}_per_frame.npy"), torch.cat(parts).cpu().numpy())
    return final_metrics
