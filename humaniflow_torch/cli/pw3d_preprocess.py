"""3DPW test-set preprocessing (the counterpart of scripts/pw3d_preprocess.py).

    python -m humaniflow_torch.cli.pw3d_preprocess --pw3d_dir 3DPW --out_dir 3dpw/test \\
        [--crop_wh 512] [--bbox_scale_factor 1.2] [--device cuda]

reads the release's sequenceFiles/test/*.pkl and imageFiles/<seq>/image_%05d.jpg
and writes what the 3DPW evaluation set reads (data/datasets.py::PW3DEvalDataset):
square crops cropped_frames/<seq>_p<person>_frame<frame>.png and 3dpw_test.npz
(imgname, pose, shape, gender, joints2D_coco in crop pixels).  Each person's
global orientation is turned by the camera's extrinsic rotation, the body is
posed by the gendered SMPL model (the converted SMPL_MALE / SMPL_FEMALE .npz,
configs/paths.py), and the projection of its vertices through the sequence's
intrinsics gives the person's box.

The JAX script poses one frame at a time.  Here each person's valid frames
whose image exists go through one batched so3_exp, one so3_log and one SMPL
forward (kernel K2, a row a frame) on the device; the rows are independent,
so the result is the per-frame one.  Decoding, boxes, crops, the joint map
and the writes stay on the host in the JAX script's arithmetic: SMPL in
float32, then the translation, the projection and Python's rounding of the
box corners in float64.  Runs on CUDA unless --device names another device.
"""

import argparse
import os
import pickle
import time

import numpy as np

from ..data.label_conversions import PW3D_JOINTS2D_TO_COCO_MAP


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--pw3d_dir", type=str, required=True,
                        help="3DPW root with sequenceFiles/ (pickles: only a release you trust) and imageFiles/")
    parser.add_argument("--out_dir", type=str, required=True)
    parser.add_argument("--crop_wh", type=int, default=512)
    parser.add_argument("--bbox_scale_factor", type=float, default=1.2)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    from ..utils.device import resolve_device

    return preprocess_pw3d(args.pw3d_dir, args.out_dir, args.crop_wh, args.bbox_scale_factor,
                           resolve_device(args.device))


def pose_person(smpl, shape, pose, cam_rot, device):
    """One person's frames on the device: the global orientation turned by
    the camera rotations, then SMPL.

    :param shape: (10,) betas; :param pose: (F, 72) axis-angle, float64;
        :param cam_rot: (F, 3, 3) extrinsic rotations, float64.
    :return: (pose (F, 72) float64 with the turned orientation in [:, :3],
        SMPL vertices (F, V, 3) float32 on the host).
    """
    import torch

    from ..models.smpl import smpl_forward
    from ..ops.so3 import so3_exp, so3_log

    f32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32, device=device)  # noqa: E731
    pose = pose.copy()
    r_glob = so3_exp(f32(pose[:, :3])).cpu().numpy()
    r = np.stack([cam_rot[i] @ r_glob[i] for i in range(len(pose))])  # float64, as the JAX script's
    pose[:, :3] = so3_log(f32(r)).cpu().numpy()
    out = smpl_forward(smpl, f32(shape).expand(len(pose), -1), f32(pose[:, 3:]), f32(pose[:, :3]), pose2rot=True)
    return pose, out["vertices"].cpu().numpy()


def person_box(verts, cam_ext, cam_k, bbox_scale_factor):
    """Square box (centre x, centre y, half side) of the vertices (V, 3)
    projected through the extrinsics (4, 4) and intrinsics (3, 3), float64."""
    v_cam = verts @ cam_ext[:3, :3].T + cam_ext[:3, 3]
    proj = (v_cam / v_cam[:, 2:]) @ cam_k.T
    x1, y1 = proj[:, 0].min(), proj[:, 1].min()
    x2, y2 = proj[:, 0].max(), proj[:, 1].max()
    return (x1 + x2) / 2, (y1 + y2) / 2, max(x2 - x1, y2 - y1) * bbox_scale_factor / 2


def crop_square(image, cx, cy, half, crop_wh):
    """The box's pixels of image (zero outside it), resized to crop_wh²;
    returns (crop, xa, ya), the box's integer top-left corner."""
    import cv2

    h, w = image.shape[:2]
    xa, xb = int(round(cx - half)), int(round(cx + half))
    ya, yb = int(round(cy - half)), int(round(cy + half))
    crop = np.zeros((yb - ya, xb - xa, 3), image.dtype)
    sy, sx = max(0, -ya), max(0, -xa)
    crop[sy : sy + min(h, yb) - max(0, ya), sx : sx + min(w, xb) - max(0, xa)] = \
        image[max(0, ya) : min(h, yb), max(0, xa) : min(w, xb)]
    return cv2.resize(crop, (crop_wh, crop_wh)), xa, ya


def preprocess_pw3d(pw3d_dir, out_dir, crop_wh=512, bbox_scale_factor=1.2, device=None) -> dict:
    """Write out_dir/cropped_frames/*.png and out_dir/3dpw_test.npz; returns
    {"frames": count, "corners": (F, 4) float64 box corners (x1, x2, y1, y2)
    before rounding, "smpl_rows": each SMPL call's frame count,
    "device_s" and "host_s": seconds on the device stage (upload, so3_exp,
    so3_log, SMPL, download) and on the rest}."""
    import cv2

    from ..configs import paths
    from ..models.smpl import load_smpl_npz
    from ..utils.device import resolve_device

    device = resolve_device(device)
    seq_dir = os.path.join(pw3d_dir, "sequenceFiles", "test")
    img_root = os.path.join(pw3d_dir, "imageFiles")
    frames_out = os.path.join(out_dir, "cropped_frames")
    os.makedirs(frames_out, exist_ok=True)
    smpl = {"m": load_smpl_npz(paths.SMPL_MALE, device=device), "f": load_smpl_npz(paths.SMPL_FEMALE, device=device)}

    imgnames, poses, shapes, genders, joints2d_coco, corners, rows = [], [], [], [], [], [], []
    device_s = 0.0
    t_start = time.perf_counter()
    for seq_file in sorted(os.listdir(seq_dir)):
        with open(os.path.join(seq_dir, seq_file), "rb") as f:
            seq = pickle.load(f, encoding="latin1")
        seq_name = str(seq["sequence"])
        cam_ext = np.asarray(seq["cam_poses"])  # (F, 4, 4)
        cam_k = np.asarray(seq["cam_intrinsics"])
        for p in range(len(seq["poses"])):
            valid = np.asarray(seq["campose_valid"][p]).astype(bool)
            img_path = lambda fi: os.path.join(img_root, seq_name, f"image_{fi:05d}.jpg")  # noqa: E731
            frames = [fi for fi in np.nonzero(valid)[0] if os.path.exists(img_path(fi))]
            if not frames:
                continue  # no SMPL call at zero rows
            shape_p = np.asarray(seq["betas"][p][:10])
            gender = str(seq["genders"][p])
            j2d_seq = np.asarray(seq["poses2d"][p])  # (F, 3, 18), OpenPose-18
            t0 = time.perf_counter()
            pose, verts_all = pose_person(smpl[gender[0]], shape_p, np.asarray(seq["poses"][p])[frames],
                                          cam_ext[frames, :3, :3], device)
            device_s += time.perf_counter() - t0
            rows.append(len(frames))
            for i, fi in enumerate(frames):
                verts = verts_all[i] + np.asarray(seq["trans"][p][fi])
                cx, cy, half = person_box(verts, cam_ext[fi], cam_k, bbox_scale_factor)
                crop, xa, ya = crop_square(cv2.imread(img_path(fi)), cx, cy, half, crop_wh)
                fname = f"{seq_name}_p{p}_frame{fi:05d}.png"
                cv2.imwrite(os.path.join(frames_out, fname), crop)

                # ground-truth 2D joints, OpenPose-18 → COCO-17, in crop pixels
                j2d_coco = j2d_seq[fi].T[PW3D_JOINTS2D_TO_COCO_MAP]
                scale = crop_wh / (2 * half)
                j2d_coco[:, 0] = (j2d_coco[:, 0] - xa) * scale
                j2d_coco[:, 1] = (j2d_coco[:, 1] - ya) * scale

                imgnames.append(fname)
                poses.append(pose[i])
                shapes.append(shape_p)
                genders.append(gender)
                joints2d_coco.append(j2d_coco)
                corners.append((cx - half, cx + half, cy - half, cy + half))

    np.savez(
        os.path.join(out_dir, "3dpw_test.npz"),
        imgname=np.array(imgnames),
        pose=np.stack(poses),
        shape=np.stack(shapes),
        gender=np.array(genders),
        joints2D_coco=np.stack(joints2d_coco),
    )
    print(f"Wrote {len(imgnames)} frames to {out_dir}")
    return {"frames": len(imgnames), "corners": np.asarray(corners, np.float64), "smpl_rows": rows,
            "device_s": device_s, "host_s": time.perf_counter() - t_start - device_s}


if __name__ == "__main__":
    main()
