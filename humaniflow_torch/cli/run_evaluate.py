"""Evaluation on SSP-3D or 3DPW (reference scripts/run_evaluate.py).

    python -m humaniflow_torch.cli.run_evaluate -D ssp3d -C humaniflow_weights.tar -B 32 -N 100
    python -m humaniflow_torch.cli.run_evaluate -D 3dpw -C humaniflow_weights.tar -B 32 -N 10

reproduce the reference's protocols: the dataset under the data directory
(configs/paths.py; HUMANIFLOW_DATA) is read with OpenCV, the model predicts N
samples per image, and the protocol's metrics are printed and saved with the
per-frame values under -S (default ./evaluations/<dataset>_eval_<N>_samples).
The SMPL models are the converted neutral, male and female .npz files
(cli/convert_model_files.py).  Runs on CUDA unless --device names another
device.  Evaluation on several devices (the JAX CLI's --num_devices) is not
ported yet.
"""

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        epilog="Evaluation on several devices (the JAX CLI's --num_devices) is not ported yet.")
    parser.add_argument("--dataset", "-D", type=str, required=True, choices=["ssp3d", "3dpw"])
    parser.add_argument("--checkpoint", "-C", type=str, required=True,
                        help="the reference's HuManiFlow .tar, or a checkpoint that train_humaniflow wrote "
                             "(its best_params, else its params)")
    parser.add_argument("--batch_size", "-B", type=int, default=32)
    parser.add_argument("--num_samples", "-N", type=int, default=10)
    parser.add_argument("--save_path", "-S", type=str, default=None)
    parser.add_argument("--extreme_crop_scale", type=float, default=None,
                        help="3DPW: crop each image to this fraction of its person box")
    parser.add_argument("--cfg", type=str, default=None, help="yaml overrides of the default config")
    parser.add_argument("--exact_silhouettes", action="store_true",
                        help="SSP-3D: render the silhouettes through the exact per-pixel coverage scan "
                             "instead of the coverage kernel")
    parser.add_argument("--sync_every", type=int, default=8,
                        help="metric device→host copy cadence in batches (1: every batch)")
    parser.add_argument("--pre_stage", action="store_true",
                        help="copy the whole dataset to the device before the loop")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    from ..configs import load_config, paths
    from ..data.datasets import PW3DEvalDataset, SSP3DEvalDataset
    from ..models import HumaniflowModel, load_smpl_npz
    from ..pipelines.evaluate import evaluate_humaniflow
    from ..pipelines.protocols import EVAL_METRICS_3DPW, EVAL_METRICS_SSP3D
    from ..utils.device import resolve_device
    from ..utils.load_reference import load_humaniflow_checkpoint

    device = resolve_device(args.device)
    cfg = load_config(args.cfg)
    model = load_humaniflow_checkpoint(args.checkpoint, HumaniflowModel(cfg.MODEL, device=device))
    regs = {"extra": paths.J_REGRESSOR_EXTRA, "cocoplus": paths.COCOPLUS_REGRESSOR, "h36m": paths.H36M_REGRESSOR}
    smpl_neutral, smpl_male, smpl_female = (
        load_smpl_npz(p, regressor_paths=regs, device=device)
        for p in (paths.SMPL_NEUTRAL, paths.SMPL_MALE, paths.SMPL_FEMALE)
    )

    # the protocols' metric sets (reference scripts/run_evaluate.py:70-94)
    if args.dataset == "3dpw":
        metrics = list(EVAL_METRICS_3DPW)
        dataset = PW3DEvalDataset(paths.PW3D_PATH, cfg, extreme_crop_scale=args.extreme_crop_scale,
                                  visible_joints_threshold=0.6)
        renderer = None
    else:
        from ..render import TexturedIUVRenderer

        metrics = list(EVAL_METRICS_SSP3D)
        dataset = SSP3DEvalDataset(paths.SSP3D_PATH, cfg)
        renderer = TexturedIUVRenderer(img_wh=cfg.DATA.PROXY_REP_SIZE, projection_type="orthographic",
                                       render_rgb=False, silhouette_exact=args.exact_silhouettes, device=device)
    save_path = args.save_path or f"./evaluations/{args.dataset}_eval_{args.num_samples}_samples"

    final = evaluate_humaniflow(
        model, smpl_neutral, smpl_male, smpl_female, cfg, dataset, metrics, batch_size=args.batch_size,
        num_pred_samples=args.num_samples, save_path=save_path, save_per_frame_metrics=True, renderer=renderer,
        sync_every=args.sync_every, pre_stage=args.pre_stage, device=device,
    )
    print(final)
    return final


if __name__ == "__main__":
    main()
