"""Prediction on a directory of uncropped images (reference scripts/run_predict.py).

    python -m humaniflow_torch.cli.run_predict -I images/ -S out/ \\
        -C humaniflow_weights.tar --hrnet_checkpoint pose_hrnet_w48_384x288.pth \\
        [--keypoint_model vitpose_h --vitpose_checkpoint vitpose-h.pth] \\
        [--num_devices 4 [--sample_devices 2]]

Person box (optional torchvision detector, else the whole image refined by
the keypoint-box fallback) → keypoints (HRNet-W48 at 384×288, or ViTPose-H
at 256×192 with --keypoint_model vitpose_h) → the square crop of the
keypoint net's crop at the proxy size → HuManiFlow distribution inference → SMPL
meshes and per-vertex uncertainty → one `<image>_pred.npz` per image.  With
-V (all of them), -VS, -VU or -VXYZ it also writes visualisations: the
`<image>_vis.png` point-estimate figure (input crop, four views coloured by
uncertainty, T-pose), the J2D-error-sorted sample grid `_samples.png`, the
composite onto the original image `_uncrop.png` and the per-vertex variance
scatter `_xyz_variance.png`.  Runs on CUDA unless --device names another
device; without checkpoints it warns and uses seeded random weights.
Images are read and written with OpenCV.  The flow runs through the fused
level kernel K5, as every pass with grad mode off does; HFT_FUSED_LEVEL=0
runs it eager.  --num_devices N runs distribution
inference on N ranks, one process a device (NCCL on CUDA, gloo on the CPU;
parallel/), each on its block of the images; with --sample_devices S as
well, the ranks form a (N / S, S) ("data", "sample") mesh whose "sample"
axis splits the N-sample SMPL stage.  The keypoint stage, the crops, the files
and the figures run on rank 0.  --trace_spans PATH records the program's
spans (utils/tracing.py) through the run and writes their summary to PATH
as JSON (rank 0's with --num_devices).
"""

import argparse
import math
import os
import sys


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--image_dir", "-I", type=str, required=True)
    parser.add_argument("--save_dir", "-S", type=str, required=True)
    parser.add_argument("--checkpoint", "-C", type=str, default=None,
                        help="the reference's HuManiFlow .tar, or a checkpoint that train_humaniflow wrote "
                             "(its best_params, else its params)")
    parser.add_argument("--hrnet_checkpoint", type=str, default=None,
                        help="the reference's HRNet-W48 .pth, or the hrnet_params.pt that "
                             "cli/convert_model_files.py writes")
    parser.add_argument("--keypoint_model", choices=["hrnet_w48", "vitpose_h"], default="hrnet_w48",
                        help="the keypoint net in front of HuManiFlow: HRNet-W48 (384x288) or ViTPose-H (256x192)")
    parser.add_argument("--vitpose_checkpoint", type=str, default=None,
                        help="ViTPose-H's released mmpose .pth (ViTPose_huge_coco_256x192)")
    parser.add_argument("--hrnet_dtype", choices=["bf16", "f32"], default="bf16",
                        help="the keypoint net's dtype of convolutions and matrix products (BatchNorm, LayerNorm, "
                             "the residual stream and the heatmaps stay float32)")
    parser.add_argument("--num_samples", "-N", "--num_pred_samples", "-NP", dest="num_samples", type=int, default=50)
    parser.add_argument("--use_detector", action="store_true",
                        help="person boxes from torchvision's Mask-RCNN (CPU), when installed")
    parser.add_argument("--cropped_images", action="store_true",
                        help="images are already cropped and centred on the person: no box detection or "
                             "keypoint-box re-crop")
    parser.add_argument("--gender", "-G", type=str, default="neutral", choices=["neutral", "male", "female"],
                        help="SMPL body model (converted .npz files under the model files directory)")
    parser.add_argument("--joints2Dvisib_threshold", "-T", type=float, default=0.75,
                        help="confidence below which appendage-joint heatmaps are zeroed in the proxy")
    parser.add_argument("--num_vis_samples", "-NV", type=int, default=8,
                        help="number of J2D-error-sorted samples in the sample-grid visualisation")
    parser.add_argument("--cfg", type=str, default=None, help="yaml overrides of the default config")
    parser.add_argument("--visualise", "-V", action="store_true",
                        help="write all visualisations (point estimate, samples, xyz variance, uncrop)")
    parser.add_argument("--visualise_samples", "-VS", action="store_true")
    parser.add_argument("--visualise_uncropped", "-VU", action="store_true")
    parser.add_argument("--visualise_xyz_variance", "-VXYZ", action="store_true")
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--num_devices", type=int, default=None,
                        help="data-parallel inference on N ranks, one a device (a 1-D data mesh); default one "
                             "process")
    parser.add_argument("--sample_devices", type=int, default=None,
                        help="split the N-sample SMPL stage over S devices (a 2-D (data, sample) mesh, data axis "
                             "num_devices // S; parallel/sample_parallel.py).  Needs --num_devices divisible by S "
                             "and --num_samples divisible by S")
    parser.add_argument("--trace_spans", type=str, default=None, metavar="PATH",
                        help="record the program's spans (utils/tracing.py) and write, per span name, the calls, "
                             "host seconds, self seconds and counters to PATH as JSON at exit (rank 0's with "
                             "--num_devices)")
    args = parser.parse_args(argv)

    from ..utils.device import resolve_device
    from ..utils.tracing import traced_to

    device = resolve_device(args.device)
    if not args.num_devices:
        with traced_to(args.trace_spans):
            return _predict(args, device)
    if args.sample_devices and args.sample_devices > 1:
        assert args.num_devices % args.sample_devices == 0, "--num_devices must be divisible by --sample_devices"

    from ..parallel import spawn

    if device.type == "cuda":
        from ..utils.cuda_build import build_all

        build_all()  # once, here: the ranks load the built kernels
    return spawn(_predict_rank, args.num_devices, device.type, args)


def _predict_rank(rank, device, args):
    from ..parallel import make_mesh, make_mesh_2d
    from ..utils.tracing import traced_to

    if rank:
        sys.stdout = open(os.devnull, "w")
    s = args.sample_devices or 1
    mesh = make_mesh_2d(args.num_devices // s, s) if s > 1 else make_mesh(args.num_devices)
    with traced_to(None if rank else args.trace_spans):
        _predict(args, device, mesh)


def _predict(args, device, mesh=None):
    import torch

    from ..configs import load_config, paths
    from ..models import HumaniflowModel, load_smpl_npz
    from ..parallel import replicate
    from ..pipelines.predict import predict_humaniflow
    from ..utils.load_reference import load_humaniflow_checkpoint

    is_root = mesh is None or torch.distributed.get_rank() == 0
    cfg = load_config(args.cfg)
    model = HumaniflowModel(cfg.MODEL, device=device)
    if args.checkpoint:
        load_humaniflow_checkpoint(args.checkpoint, model)
    else:
        print("WARNING: no checkpoint given, using random init")
    if mesh is not None:
        replicate(model, mesh)
    smpl_path = {"neutral": paths.SMPL_NEUTRAL, "male": paths.SMPL_MALE, "female": paths.SMPL_FEMALE}[args.gender]
    smpl = load_smpl_npz(
        smpl_path,
        regressor_paths={"extra": paths.J_REGRESSOR_EXTRA, "cocoplus": paths.COCOPLUS_REGRESSOR,
                         "h36m": paths.H36M_REGRESSOR},
        device=device,
    )

    fnames, hr, crop = _hrnet_crops(args, cfg, device) if is_root else (None, None, None)
    if mesh is not None:  # rank 0's crops to every rank, through the host
        moved = lambda d, dev: {k: v.to(dev) if isinstance(v, torch.Tensor) else v for k, v in d.items()}  # noqa: E731
        crops = [(fnames, moved(hr, "cpu"), moved(crop, "cpu")) if is_root else None]
        torch.distributed.broadcast_object_list(crops, src=0)
        fnames, hr, crop = crops[0][0], moved(crops[0][1], device), moved(crops[0][2], device)
    n = len(fnames)
    pred = predict_humaniflow(
        model, smpl, cfg, crop["rgb"], crop["joints2d"], hr["joints2Dconfs"], num_samples=args.num_samples,
        save_dir=args.save_dir, fnames=fnames,
        extras={"bbox_centre": hr["bbox_centres"], "bbox_height": hr["bbox_heights"],
                "bbox_width": hr["bbox_widths"], "hrnet_joints2D": hr["joints2D"]},
        joints2d_visib_threshold=args.joints2Dvisib_threshold, device=device, mesh=mesh,
    )
    if not is_root:
        return
    print(f"Saved predictions for {n} images to {args.save_dir}")
    vis_samples = args.visualise or args.visualise_samples
    vis_uncrop = args.visualise or args.visualise_uncropped
    vis_xyz = args.visualise or args.visualise_xyz_variance
    if args.visualise or vis_samples or vis_uncrop or vis_xyz:
        _visualise(args, cfg, pred, crop["rgb"], hr, fnames, vis_samples, vis_uncrop, vis_xyz, device)


def _keypoint_net(args, device):
    """The keypoint net that --keypoint_model names, with its checkpoint."""
    import torch

    from ..models import vitpose
    from ..models.hrnet import PoseHighResolutionNet
    from ..utils.load_reference import load_hrnet_checkpoint, load_vitpose_checkpoint

    dtype = torch.bfloat16 if args.hrnet_dtype == "bf16" else None
    if args.keypoint_model == "vitpose_h":
        net = vitpose.ViTPose(**vitpose.VITPOSE_H, dtype=dtype, device=device)
        checkpoint, load, label = args.vitpose_checkpoint, load_vitpose_checkpoint, "ViTPose"
    else:
        net = PoseHighResolutionNet(dtype=dtype, device=device)
        checkpoint, load, label = args.hrnet_checkpoint, load_hrnet_checkpoint, "HRNet"
    if checkpoint:
        load(checkpoint, net)
    else:
        print(f"WARNING: no {label} checkpoint, using random init")
    return net


def _hrnet_crops(args, cfg, device):
    """Keypoints of the images of -I, then the square centre crop of each
    keypoint net's crop at the proxy size: (file names, the keypoint stage's
    outputs, the crops)."""
    import cv2
    import numpy as np
    import torch

    from ..data.image_ops import batch_crop_affine
    from ..pipelines.predict_hrnet import keypoint_sizes, predict_hrnet_batch

    hrnet = _keypoint_net(args, device)
    os.makedirs(args.save_dir, exist_ok=True)
    fnames = sorted(f for f in os.listdir(args.image_dir) if f.endswith((".png", ".jpg", ".jpeg")))
    raw_images = [
        cv2.cvtColor(cv2.imread(os.path.join(args.image_dir, f)), cv2.COLOR_BGR2RGB).astype(np.float32) / 255.0
        for f in fnames
    ]
    hr = predict_hrnet_batch(
        hrnet, raw_images, use_torchvision_detector=args.use_detector and not args.cropped_images,
        keypoint_bbox_fallback=not args.cropped_images, device=device,
    )
    n, wh = len(fnames), cfg.DATA.PROXY_REP_SIZE
    (in_w, in_h), _ = keypoint_sizes(hrnet)
    side = max(in_w, in_h)
    crop = batch_crop_affine(
        (wh, wh), rgb=hr["cropped_images"], joints2d=hr["joints2D"],
        bbox_centres=torch.tensor([in_h / 2.0, in_w / 2.0], device=device).expand(n, 2),
        bbox_heights=torch.full((n,), float(side), device=device),
        bbox_widths=torch.full((n,), float(side), device=device), orig_scale_factor=1.0,
    )
    return fnames, hr, crop


def _visualise(args, cfg, pred, images, hr, fnames, vis_samples, vis_uncrop, vis_xyz, device):
    """Write the visualisations that the flags ask for."""
    import cv2
    import numpy as np
    import torch

    from ..ops import aa_rotate_translate_points
    from ..render import TexturedIUVRenderer
    from ..utils.sampling import joints2d_error_sorted_verts_sampling
    from ..utils.visualise import (
        plot_xyz_vertex_variance,
        render_point_est_visualisation,
        render_samples_visualisation,
        uncertainty_colourmap,
        uncrop_point_est_visualisation,
    )

    renderer = TexturedIUVRenderer(img_wh=cfg.DATA.PROXY_REP_SIZE, projection_type="orthographic", device=device)
    colours = np.stack([uncertainty_colourmap(v) for v in pred["vertex_uncertainty_l2"].cpu().numpy()])
    x_axis, zero = torch.tensor([1.0, 0.0, 0.0], device=device), torch.zeros(3, device=device)
    flip = lambda v: aa_rotate_translate_points(v, x_axis, math.pi, zero)  # noqa: E731
    with torch.inference_mode():
        verts_flipped = flip(pred["verts_point_est"])
        tpose_flipped = flip(pred["tpose_verts"])
    figs = render_point_est_visualisation(renderer, verts_flipped, pred["cam_wp"], input_image=images.cpu().numpy(),
                                          tpose_vertices=tpose_flipped, vertex_colours=colours)
    proxy = pred["proxy_rep"]
    boxes = {k: np.asarray(hr[k]) for k in ("bbox_centres", "bbox_heights", "bbox_widths")}
    for i, fname in enumerate(fnames):
        stem = os.path.splitext(fname)[0]
        cv2.imwrite(os.path.join(args.save_dir, stem + "_vis.png"),
                    (figs["figure"][i][:, :, ::-1] * 255).astype(np.uint8))
        if vis_samples:
            with torch.inference_mode():
                sorted_verts = joints2d_error_sorted_verts_sampling(
                    pred["verts_samples"][i], pred["joints_samples"][i], proxy[i, :, :, 1:].permute(2, 0, 1)[None],
                    pred["cam_wp"][i:i + 1],
                )[:args.num_vis_samples]
                sorted_flipped = flip(sorted_verts)
            nv = sorted_flipped.shape[0]
            cols = min(nv, 6)
            grid = render_samples_visualisation(renderer, sorted_flipped, pred["cam_wp"][i:i + 1],
                                                num_rows=math.ceil(nv / cols), num_cols=cols)
            cv2.imwrite(os.path.join(args.save_dir, stem + "_samples.png"), (grid[:, :, ::-1] * 255).astype(np.uint8))
        if vis_xyz:
            plot_xyz_vertex_variance(verts_flipped[i].cpu().numpy(),
                                     pred["vertex_uncertainty_directional"][i].cpu().numpy(),
                                     save_path=os.path.join(args.save_dir, stem + "_xyz_variance.png"))
        if vis_uncrop:
            orig = cv2.cvtColor(cv2.imread(os.path.join(args.image_dir, fname)), cv2.COLOR_BGR2RGB)
            render0 = figs["renders"]["0"][i:i + 1]
            sil0 = (render0.sum(-1) > 0).astype(np.float32)
            wh_box = max(boxes["bbox_heights"][i], boxes["bbox_widths"][i])
            uncropped = uncrop_point_est_visualisation(
                render0, sil0, boxes["bbox_centres"][i][None], np.asarray([wh_box]),
                (orig.astype(np.float32) / 255.0)[None], bbox_scale_factor=cfg.DATA.BBOX_SCALE_FACTOR,
            )
            cv2.imwrite(os.path.join(args.save_dir, stem + "_uncrop.png"),
                        (uncropped[0][:, :, ::-1] * 255).astype(np.uint8))
    done = ["point-est"] + [name for name, on in (("samples", vis_samples), ("xyz variance", vis_xyz),
                                                   ("uncrop", vis_uncrop)) if on]
    print(f"Saved visualisations ({', '.join(done)}).")


if __name__ == "__main__":
    main()
