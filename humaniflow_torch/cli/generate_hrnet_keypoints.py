"""HRNet-W48 keypoints for a directory of square cropped frames (the
counterpart of scripts/generate_hrnet_keypoints.py).

    python -m humaniflow_torch.cli.generate_hrnet_keypoints --frames_dir 3dpw/test/cropped_frames \\
        --out_path 3dpw/test/hrnet_results_centred.npy [--hrnet_checkpoint pose_hrnet_w48_384x288.pth] \\
        [--batch_size 16] [--device cuda]

writes the `hrnet_results_centred.npy` that the 3DPW evaluation set reads
(data/datasets.py::PW3DEvalDataset): one (17, 3) row of COCO keypoints
(x, y in the frame's pixels, confidence) per .png/.jpg frame, in the
frames' sorted order, float32.  Each frame is read and resized to HRNet's
input on the host (OpenCV); each batch is uploaded, normalised, run
through HRNet-W48 in float32 with TF32 off and decoded by argmax on the
device (pipelines/predict_hrnet.py).  The checkpoint is the reference's
.pth or the hrnet_params.pt that cli/convert_model_files.py writes; without
one the net has seeded random weights (a warning says so).  Runs on CUDA
unless --device names another device.
"""

import argparse
import os


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--frames_dir", type=str, required=True)
    parser.add_argument("--out_path", type=str, required=True)
    parser.add_argument("--hrnet_checkpoint", type=str, default=None,
                        help="the reference's HRNet-W48 .pth, or the hrnet_params.pt that "
                             "cli/convert_model_files.py writes")
    parser.add_argument("--batch_size", type=int, default=16)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    import torch

    from ..utils.device import resolve_device

    device = resolve_device(args.device)

    import cv2
    import numpy as np

    from ..models.hrnet import PoseHighResolutionNet
    from ..pipelines.predict_hrnet import crop_keypoints, keypoint_sizes
    from ..utils.load_reference import load_hrnet_checkpoint

    hrnet = PoseHighResolutionNet(device=device, generator=torch.Generator().manual_seed(0))
    if args.hrnet_checkpoint:
        load_hrnet_checkpoint(args.hrnet_checkpoint, hrnet)
    else:
        print("WARNING: no HRNet checkpoint — random init")

    fnames = sorted(f for f in os.listdir(args.frames_dir) if f.endswith((".png", ".jpg")))
    results = np.zeros((len(fnames), 17, 3), np.float32)
    (w_in, h_in), _ = keypoint_sizes(hrnet)  # read at call time, as the JAX script does
    for start in range(0, len(fnames), args.batch_size):
        chunk = fnames[start : start + args.batch_size]
        imgs = np.zeros((len(chunk), h_in, w_in, 3), np.float32)
        scales = np.zeros((len(chunk), 2), np.float32)
        for i, f in enumerate(chunk):
            img = cv2.cvtColor(cv2.imread(os.path.join(args.frames_dir, f)), cv2.COLOR_BGR2RGB)
            oh, ow = img.shape[:2]
            imgs[i] = cv2.resize(img, (w_in, h_in)) / 255.0
            # keypoints come out in HRNet-input pixels; map them to frame pixels
            scales[i] = [ow / w_in, oh / h_in]
        kps, confs = crop_keypoints(hrnet, torch.from_numpy(imgs).to(device))
        results[start : start + len(chunk), :, :2] = kps.cpu().numpy() * scales[:, None, :]
        results[start : start + len(chunk), :, 2] = confs.cpu().numpy()
        if start % (args.batch_size * 10) == 0:
            print(f"{start}/{len(fnames)}")

    np.save(args.out_path, results)
    print(f"Wrote {results.shape} → {args.out_path}")
    return results


if __name__ == "__main__":
    main()
