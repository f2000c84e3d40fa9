"""Convert an SMPL body-model .pkl into the .npz that every CLI of the package reads.

    python -m humaniflow_torch.cli.convert_model_files --smpl_pkl SMPL_NEUTRAL.pkl \\
        [--smpl_out model_files/smpl/SMPL_NEUTRAL.npz] [--out_dir model_files/converted]

The .npz goes to --smpl_out, else to --out_dir under the .pkl's name.  Put the
neutral, male and female files under model_files/smpl/ (or the directory that
HUMANIFLOW_MODEL_FILES names).  The network weights need no conversion: the
CLIs read the reference's humaniflow_weights.tar and pose_hrnet_w48_384x288.pth
as they are (utils/load_reference.py).
"""

import argparse
import os


def main(argv=None):
    parser = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        epilog="The network weights need no conversion: the CLIs read the reference's humaniflow_weights.tar and "
               "pose_hrnet_w48_384x288.pth as they are.")
    parser.add_argument("--smpl_pkl", type=str, required=True, help="the SMPL .pkl (only files you trust)")
    parser.add_argument("--smpl_out", type=str, default=None, help="the .npz to write")
    parser.add_argument("--out_dir", type=str, default="model_files/converted",
                        help="where the .npz goes without --smpl_out")
    args = parser.parse_args(argv)

    from ..models.smpl import convert_smpl_pkl

    out = args.smpl_out or os.path.join(
        args.out_dir, os.path.splitext(os.path.basename(args.smpl_pkl))[0] + ".npz")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    convert_smpl_pkl(args.smpl_pkl, out)
    print("SMPL →", out)
    return out


if __name__ == "__main__":
    main()
