"""Synthetic-data training (reference scripts/run_train.py).

    python -m humaniflow_torch.cli.run_train -E experiments/run1 [-P all] \\
        [--cfg train.yaml] [-O TRAIN.BATCH_SIZE 72 ...] [-R EPOCH] [--no-cull] [-D 4]

Samples poses, textures and LSUN backgrounds from the training files under
the data directory (configs/paths.py; HUMANIFLOW_DATA), renders the
synthetic batch on the device and trains the model (pipelines/train.py),
writing `config.yaml`, `log.pkl` and an `epoch_XXXXXX.pt` checkpoint every
TRAIN.EPOCHS_PER_SAVE epochs into -E.  The experiment's config is frozen on
the first run; `-R EPOCH` resumes from that epoch's checkpoint with the
frozen config and this run's -O on top.  The SMPL model is the converted
SMPL_NEUTRAL.npz (cli/convert_model_files.py).  Runs on CUDA unless
--device names another device.  -D N trains data-parallel on N ranks, one
process a device (NCCL on CUDA, gloo on the CPU; parallel/): each rank
takes TRAIN.BATCH_SIZE / N of every batch, which N must divide, and rank 0
writes the files.
"""

import argparse
import os
import sys


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--experiment_dir", "-E", type=str, required=True)
    parser.add_argument("--pose_params_from", "-P", type=str, default="all",
                        choices=["all", "h36m", "up3d", "3dpw", "amass", "not_amass"])
    parser.add_argument("--resume_epoch", "-R", type=int, default=None)
    parser.add_argument("--cfg", type=str, default=None, help="yaml overrides of the default config")
    parser.add_argument("--cfg_overrides", "-O", nargs="*", default=[],
                        help="dotted-path overrides, KEY VALUE pairs (e.g. TRAIN.BATCH_SIZE 72)")
    parser.add_argument("--num_devices", "-D", type=int, default=None,
                        help="data-parallel training on N ranks, one a device (a 1-D data mesh); "
                             "default one process")
    parser.add_argument("--cull", default=True, action=argparse.BooleanOptionalAction,
                        help="back-face-cull the synthetic-data renders (exact for closed, consistently wound "
                             "meshes such as SMPL's); --no-cull for meshes that self-intersect")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    from ..configs import load_config, save_config
    from ..utils.device import resolve_device

    device = resolve_device(args.device)
    os.makedirs(args.experiment_dir, exist_ok=True)
    frozen_cfg_path = os.path.join(args.experiment_dir, "config.yaml")
    if args.resume_epoch is not None and os.path.exists(frozen_cfg_path):
        cfg = load_config(frozen_cfg_path, args.cfg_overrides)
    else:
        cfg = load_config(args.cfg, args.cfg_overrides)
        save_config(cfg, frozen_cfg_path)
    if not args.num_devices:
        return _train(args, cfg, device)

    from ..parallel import spawn

    if device.type == "cuda":
        from ..utils.cuda_build import build_all

        build_all()  # once, here: the ranks load the built kernels
    return spawn(_train_rank, args.num_devices, device.type, args, cfg)


def _train_rank(rank, device, args, cfg):
    from ..parallel import make_mesh

    if rank:
        sys.stdout = open(os.devnull, "w")
    _train(args, cfg, device, mesh=make_mesh(args.num_devices))


def _train(args, cfg, device, mesh=None):
    from ..configs import paths
    from ..data.datasets import OnTheFlySMPLTrainDataset
    from ..models import HumaniflowModel, load_smpl_npz
    from ..pipelines.train import make_training_renderer, train_humaniflow
    from ..utils.checkpoints import load_checkpoint

    datasets = [
        OnTheFlySMPLTrainDataset(poses_path=poses, textures_path=textures, backgrounds_dir_path=backgrounds,
                                 params_from=args.pose_params_from, img_wh=cfg.DATA.PROXY_REP_SIZE)
        for poses, textures, backgrounds in (
            (paths.TRAIN_POSES_PATH, paths.TRAIN_TEXTURES_PATH, paths.TRAIN_BACKGROUNDS_PATH),
            (paths.VAL_POSES_PATH, paths.VAL_TEXTURES_PATH, paths.VAL_BACKGROUNDS_PATH),
        )
    ]
    print(f"Found {len(datasets[0])} train / {len(datasets[1])} val poses.")

    smpl = load_smpl_npz(
        paths.SMPL_NEUTRAL,
        regressor_paths={"extra": paths.J_REGRESSOR_EXTRA, "cocoplus": paths.COCOPLUS_REGRESSOR,
                         "h36m": paths.H36M_REGRESSOR},
        device=device,
    )
    renderer = make_training_renderer(cfg, cull=args.cull, device=device)
    model = HumaniflowModel(cfg.MODEL, device=device)
    resume_state = None
    if args.resume_epoch is not None:
        resume_state = load_checkpoint(os.path.join(args.experiment_dir, f"epoch_{args.resume_epoch:06d}"))
    return train_humaniflow(model, smpl, cfg, renderer, *datasets, args.experiment_dir, resume_state=resume_state,
                            mesh=mesh)


if __name__ == "__main__":
    main()
