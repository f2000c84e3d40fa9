"""Convert external model files into the formats the package reads.

    python -m humaniflow_torch.cli.convert_model_files [--smpl_pkl SMPL_NEUTRAL.pkl] \\
        [--smpl_out model_files/smpl/SMPL_NEUTRAL.npz] [--humaniflow_tar humaniflow_weights.tar] \\
        [--hrnet_pth pose_hrnet_w48_384x288.pth] [--out_dir model_files/converted]

* --smpl_pkl: an SMPL body-model .pkl → the .npz that every CLI reads, at
  --smpl_out, else under --out_dir by the .pkl's name.  Put the neutral,
  male and female files under model_files/smpl/ (or the directory that
  HUMANIFLOW_MODEL_FILES names).
* --humaniflow_tar: the reference's HuManiFlow weights → --out_dir/
  humaniflow_params.pt, {"params": state_dict} in the port's names
  (utils/checkpoints.py), which -C of the predict, optimise and evaluate
  CLIs loads.
* --hrnet_pth: the reference's HRNet-W48 weights → --out_dir/
  hrnet_params.pt, {"params": state_dict}, which the predict CLI's
  HRNet option and cli/generate_hrnet_keypoints.py load.

The CLIs also read the reference's .tar and .pth as they are
(utils/load_reference.py); the converted files skip the name mapping.  The
conversion runs on the CPU.
"""

import argparse
import os


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--smpl_pkl", type=str, default=None, help="an SMPL .pkl (only files you trust)")
    parser.add_argument("--smpl_out", type=str, default=None, help="the .npz to write")
    parser.add_argument("--humaniflow_tar", type=str, default=None, help="the reference's humaniflow_weights.tar")
    parser.add_argument("--hrnet_pth", type=str, default=None, help="the reference's pose_hrnet_w48_384x288.pth")
    parser.add_argument("--out_dir", type=str, default="model_files/converted",
                        help="where the converted files go (the SMPL .npz only without --smpl_out)")
    args = parser.parse_args(argv)

    written = {}
    if args.smpl_pkl:
        from ..models.smpl import convert_smpl_pkl

        out = args.smpl_out or os.path.join(
            args.out_dir, os.path.splitext(os.path.basename(args.smpl_pkl))[0] + ".npz")
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        convert_smpl_pkl(args.smpl_pkl, out)
        print("SMPL →", out)
        written["smpl"] = out

    if args.humaniflow_tar:
        from ..configs import get_humaniflow_cfg_defaults
        from ..models import HumaniflowModel
        from ..utils.checkpoints import save_checkpoint
        from ..utils.load_reference import load_humaniflow_checkpoint

        model = load_humaniflow_checkpoint(
            args.humaniflow_tar, HumaniflowModel(get_humaniflow_cfg_defaults().MODEL, device="cpu"))
        written["humaniflow"] = save_checkpoint(args.out_dir, "humaniflow_params", {"params": model.state_dict()})
        print("HuManiFlow weights →", written["humaniflow"])

    if args.hrnet_pth:
        from ..models import PoseHighResolutionNet
        from ..utils.checkpoints import save_checkpoint
        from ..utils.load_reference import load_hrnet_checkpoint

        hrnet = load_hrnet_checkpoint(args.hrnet_pth, PoseHighResolutionNet(device="cpu"))
        written["hrnet"] = save_checkpoint(args.out_dir, "hrnet_params", {"params": hrnet.state_dict()})
        print("HRNet weights →", written["hrnet"])
    return written


if __name__ == "__main__":
    main()
