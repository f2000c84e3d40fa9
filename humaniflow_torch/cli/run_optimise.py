"""Refine predictions with the flow prior (reference scripts/run_optimise.py).

    python -m humaniflow_torch.cli.run_optimise -I images/ -P pred_out/ -S opt_out/ \\
        -C humaniflow_weights.tar [--optimise_cfg opt.yaml] [--no_visualise]

Reads the `<image>_pred.npz` dumps that the predict CLI wrote for the images
of -I, refines shape, pose, global rotation and camera against each image's
2D keypoints with the image-conditioned distribution as prior
(pipelines/optimise.py), and writes one `<image>_opt.npz` per image (pose
axis-angle, shape, camera), printing the loss terms before and after.
Unless --no_visualise, it also writes the `<image>_opt.png` point-estimate
figure and, where the dump holds the person box, the `<image>_opt_uncrop.png`
composite onto the original image (OpenCV).  Runs on CUDA unless --device
names another device.
"""

import argparse
import math
import os


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--pred_image_dir", "-I", type=str, required=True)
    parser.add_argument("--pred_output_dir", "-P", type=str, required=True)
    parser.add_argument("--opt_output_dir", "-S", type=str, required=True)
    parser.add_argument("--checkpoint", "-C", type=str, required=True,
                        help="the reference's HuManiFlow .tar, or a checkpoint that train_humaniflow wrote "
                             "(its best_params, else its params)")
    parser.add_argument("--cfg", type=str, default=None, help="yaml overrides of the default config")
    parser.add_argument("--optimise_cfg", type=str, default=None,
                        help="yaml overriding the optimisation config (LR, NUM_ITERS, LOSS_WEIGHTS, "
                             "JOINTS2D_VISIB_THRESHOLD)")
    parser.add_argument("--no_visualise", action="store_true", help="skip the renders after the optimisation")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    import numpy as np

    from ..configs import load_config, load_optimise_config, paths
    from ..data.datasets import load_opt_initialise_data_from_pred_output
    from ..models import HumaniflowModel, load_smpl_npz
    from ..pipelines.optimise import optimise_batch_with_humaniflow_prior
    from ..utils.device import resolve_device
    from ..utils.load_reference import load_humaniflow_checkpoint

    device = resolve_device(args.device)
    cfg = load_config(args.cfg)
    opt_cfg = load_optimise_config(args.optimise_cfg)
    model = load_humaniflow_checkpoint(args.checkpoint, HumaniflowModel(cfg.MODEL, device=device))
    smpl = load_smpl_npz(
        paths.SMPL_NEUTRAL,
        regressor_paths={"extra": paths.J_REGRESSOR_EXTRA, "cocoplus": paths.COCOPLUS_REGRESSOR,
                         "h36m": paths.H36M_REGRESSOR},
        device=device,
    )
    data = load_opt_initialise_data_from_pred_output(args.pred_image_dir, args.pred_output_dir)
    init = {
        "shape": data["shape_mode"],
        "pose_axisangle": data["pose_axisangle_point_est"],
        "glob_rotmat": data["glob_rotmat"],
        "cam_wp": data["cam_wp"],
        "input_feats": data["input_feats"],
        "joints2D": data["cropped_joints2D"],
        "joints2D_conf": data["hrnet_joints2D_conf"],
    }
    out = optimise_batch_with_humaniflow_prior(model, smpl, opt_cfg, init, img_wh=cfg.DATA.PROXY_REP_SIZE,
                                               device=device)
    host = {k: out[k].cpu().numpy() for k in ("pose_axisangle", "glob_axisangle", "shape", "cam_wp")}

    os.makedirs(args.opt_output_dir, exist_ok=True)
    for i, fname in enumerate(data["fnames"]):
        np.savez(os.path.join(args.opt_output_dir, os.path.splitext(fname)[0] + "_opt.npz"),
                 pose_axisangle=host["pose_axisangle"][i], shape=host["shape"][i], cam_wp=host["cam_wp"][i])
    print(f"Optimised {len(data['fnames'])} predictions → {args.opt_output_dir}")
    print("initial losses:", {k: float(v) for k, v in out["initial_losses"].items()})
    print("final losses:  ", {k: float(v) for k, v in out["final_losses"].items()})

    if args.no_visualise or not os.path.exists(paths.DENSEPOSE_UV):
        return
    import cv2
    import torch

    from ..models import smpl_forward
    from ..ops import aa_rotate_translate_points, so3_exp
    from ..render import TexturedIUVRenderer
    from ..utils.visualise import render_point_est_visualisation, uncrop_point_est_visualisation

    renderer = TexturedIUVRenderer(img_wh=cfg.DATA.PROXY_REP_SIZE, projection_type="orthographic", device=device)
    with torch.inference_mode():
        verts = smpl_forward(smpl, out["shape"], so3_exp(out["pose_axisangle"]), so3_exp(out["glob_axisangle"]))
        x_axis = torch.tensor([1.0, 0.0, 0.0], device=device)
        verts_flipped = aa_rotate_translate_points(verts["vertices"], x_axis, math.pi, torch.zeros(3, device=device))
    proxy_vis = None
    if "proxy_rep" in data:
        proxy_vis = np.clip(data["proxy_rep"].sum(axis=-1, keepdims=True).repeat(3, axis=-1), 0.0, 1.0)
    figs = render_point_est_visualisation(
        renderer, verts_flipped, out["cam_wp"], input_image=data.get("cropped_image"), proxy_image=proxy_vis,
        joints2d=data.get("cropped_joints2D"), joints2d_confs=data.get("hrnet_joints2D_conf"),
    )
    have_bbox = all(k in data for k in ("bbox_centre", "bbox_height", "bbox_width"))
    for i, fname in enumerate(data["fnames"]):
        stem = os.path.splitext(fname)[0]
        cv2.imwrite(os.path.join(args.opt_output_dir, stem + "_opt.png"),
                    (figs["figure"][i][:, :, ::-1] * 255).astype(np.uint8))
        if not have_bbox:
            continue
        orig = cv2.imread(os.path.join(args.pred_image_dir, fname))
        if orig is None:
            continue
        orig = cv2.cvtColor(orig, cv2.COLOR_BGR2RGB).astype(np.float32) / 255.0
        render0 = figs["renders"]["0"][i:i + 1]
        sil0 = (render0.sum(-1) > 0).astype(np.float32)
        wh_box = max(float(data["bbox_height"][i]), float(data["bbox_width"][i]))
        uncropped = uncrop_point_est_visualisation(render0, sil0, data["bbox_centre"][i][None], np.asarray([wh_box]),
                                                   orig[None], bbox_scale_factor=cfg.DATA.BBOX_SCALE_FACTOR)
        cv2.imwrite(os.path.join(args.opt_output_dir, stem + "_opt_uncrop.png"),
                    (uncropped[0][:, :, ::-1] * 255).astype(np.uint8))
    print("Saved post-optimisation visualisations (_opt.png, _opt_uncrop.png).")


if __name__ == "__main__":
    main()
