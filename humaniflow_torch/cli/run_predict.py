"""Prediction on a directory of uncropped images (reference scripts/run_predict.py).

    python -m humaniflow_torch.cli.run_predict -I images/ -S out/ \\
        -C humaniflow_weights.tar --hrnet_checkpoint pose_hrnet_w48_384x288.pth

Person box (optional torchvision detector, else the whole image refined by
the keypoint-box fallback) → HRNet-W48 keypoints → the square crop of the
HRNet crop at the proxy size → HuManiFlow distribution inference → SMPL
meshes and per-vertex uncertainty → one `<image>_pred.npz` per image.  Runs
on CUDA unless --device names another device; without checkpoints it warns
and uses seeded random weights.  Images are read with OpenCV.  Setting
HFT_FUSED_LEVEL=1 runs the flow through the fused level kernel.
"""

import argparse
import os


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--image_dir", "-I", type=str, required=True)
    parser.add_argument("--save_dir", "-S", type=str, required=True)
    parser.add_argument("--checkpoint", "-C", type=str, default=None, help="the reference's HuManiFlow .tar")
    parser.add_argument("--hrnet_checkpoint", type=str, default=None, help="the reference's HRNet-W48 .pth")
    parser.add_argument("--hrnet_dtype", choices=["bf16", "f32"], default="bf16",
                        help="HRNet convolution dtype (BatchNorm and heatmaps stay float32)")
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
    parser.add_argument("--cfg", type=str, default=None, help="yaml overrides of the default config")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    import numpy as np
    import torch

    from ..configs import load_config, paths
    from ..data.image_ops import batch_crop_affine
    from ..models import HumaniflowModel, load_smpl_npz
    from ..models.hrnet import PoseHighResolutionNet
    from ..pipelines import predict_hrnet as ph
    from ..pipelines.predict import predict_humaniflow
    from ..utils.device import resolve_device
    from ..utils.load_reference import load_hrnet_checkpoint, load_humaniflow_checkpoint

    device = resolve_device(args.device)
    cfg = load_config(args.cfg)
    model = HumaniflowModel(cfg.MODEL, device=device)
    if args.checkpoint:
        load_humaniflow_checkpoint(args.checkpoint, model)
    else:
        print("WARNING: no checkpoint given, using random init")
    hrnet = PoseHighResolutionNet(dtype=torch.bfloat16 if args.hrnet_dtype == "bf16" else None, device=device)
    if args.hrnet_checkpoint:
        load_hrnet_checkpoint(args.hrnet_checkpoint, hrnet)
    else:
        print("WARNING: no HRNet checkpoint, using random init")
    smpl_path = {"neutral": paths.SMPL_NEUTRAL, "male": paths.SMPL_MALE, "female": paths.SMPL_FEMALE}[args.gender]
    smpl = load_smpl_npz(
        smpl_path,
        regressor_paths={"extra": paths.J_REGRESSOR_EXTRA, "cocoplus": paths.COCOPLUS_REGRESSOR,
                         "h36m": paths.H36M_REGRESSOR},
        device=device,
    )

    import cv2

    os.makedirs(args.save_dir, exist_ok=True)
    fnames = sorted(f for f in os.listdir(args.image_dir) if f.endswith((".png", ".jpg", ".jpeg")))
    raw_images = [
        cv2.cvtColor(cv2.imread(os.path.join(args.image_dir, f)), cv2.COLOR_BGR2RGB).astype(np.float32) / 255.0
        for f in fnames
    ]
    hr = ph.predict_hrnet_batch(
        hrnet, raw_images, use_torchvision_detector=args.use_detector and not args.cropped_images,
        keypoint_bbox_fallback=not args.cropped_images, device=device,
    )

    # the square centre crop of each HRNet crop, at the proxy size
    n, wh = len(fnames), cfg.DATA.PROXY_REP_SIZE
    in_w, in_h = ph.HRNET_INPUT_WH
    side = max(in_w, in_h)
    crop = batch_crop_affine(
        (wh, wh), rgb=hr["cropped_images"], joints2d=hr["joints2D"],
        bbox_centres=torch.tensor([in_h / 2.0, in_w / 2.0], device=device).expand(n, 2),
        bbox_heights=torch.full((n,), float(side), device=device),
        bbox_widths=torch.full((n,), float(side), device=device), orig_scale_factor=1.0,
    )
    predict_humaniflow(
        model, smpl, cfg, crop["rgb"], crop["joints2d"], hr["joints2Dconfs"], num_samples=args.num_samples,
        save_dir=args.save_dir, fnames=fnames,
        extras={"bbox_centre": hr["bbox_centres"], "bbox_height": hr["bbox_heights"],
                "bbox_width": hr["bbox_widths"], "hrnet_joints2D": hr["joints2D"]},
        joints2d_visib_threshold=args.joints2Dvisib_threshold, device=device,
    )
    print(f"Saved predictions for {n} images to {args.save_dir}")


if __name__ == "__main__":
    main()
