"""The synthetic-training sampler, the SSP-3D and 3DPW evaluation
datasets, the batch iterator and the optimise-data loader.

The counterpart of `humaniflow_tpu/data/datasets.py`: host-side numpy code
(file IO, decode, crop).  The training sampler yields poses, textures and
backgrounds that the train loop renders on the device; the evaluation
datasets emit uint8 images and keypoints, whose heatmaps the eval step
builds on the device.
"""

import os
from typing import Iterator, Optional

import numpy as np

try:
    import cv2
except Exception:  # pragma: no cover
    cv2 = None

from ..configs.defaults import HumaniflowConfig
from .native_loader import decode_jpeg_batch


class OnTheFlySMPLTrainDataset:
    """Synthetic-training pose, texture and background sampler (reference
    on_the_fly_smpl_train_dataset.py:8-96): raw materials only, rendered on
    the device by the train loop.  Draws from np.random.default_rng(seed) in
    the JAX package's order (per item the texture coin and index, then the
    background indices; per epoch the permutation first), so that both
    packages give the same batches from the same seed."""

    def __init__(
        self,
        poses_path: str,
        textures_path: str,
        backgrounds_dir_path: str,
        params_from: str = "all",
        grey_tex_prob: float = 0.05,
        img_wh: int = 256,
        seed: int = 0,
    ):
        assert params_from in ("all", "h36m", "up3d", "3dpw", "amass", "not_amass")
        data = np.load(poses_path)
        fnames = list(data["fnames"])
        poses = data["poses"]
        if params_from != "all":
            def is_not_amass(f):
                f = str(f)
                return f.startswith("h36m") or f.startswith("up3d") or f.startswith("3dpw")

            if params_from == "not_amass":
                keep = [i for i, f in enumerate(fnames) if is_not_amass(f)]
            elif params_from == "amass":
                keep = [i for i, f in enumerate(fnames) if not is_not_amass(f)]
            else:
                keep = [i for i, f in enumerate(fnames) if str(f).startswith(params_from)]
            fnames = [fnames[i] for i in keep]
            poses = poses[keep]
        self.fnames = fnames
        self.poses = np.asarray(poses, np.float32)

        textures = np.load(textures_path)
        self.grey_textures = textures["grey"]
        self.nongrey_textures = textures["nongrey"]
        self.grey_tex_prob = grey_tex_prob

        self.backgrounds_paths = sorted(
            os.path.join(backgrounds_dir_path, f) for f in os.listdir(backgrounds_dir_path) if f.endswith(".jpg")
        )
        self.img_wh = img_wh
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.poses)

    def sample_batch(self, indices) -> dict:
        """{pose (B, 72), texture (B, 1200, 800, 3), background (B, wh, wh,
        3)}, float32 NHWC in [0, 1]."""
        b = len(indices)
        poses = self.poses[indices]
        textures = np.empty((b, 1200, 800, 3), np.float32)
        for i in range(b):
            if self.rng.random() < self.grey_tex_prob:
                tex = self.grey_textures[self.rng.integers(len(self.grey_textures))]
            else:
                tex = self.nongrey_textures[self.rng.integers(len(self.nongrey_textures))]
            textures[i] = tex / 255.0
        paths = [self.backgrounds_paths[self.rng.integers(len(self.backgrounds_paths))] for _ in range(b)]
        return {"pose": poses, "texture": textures, "background": decode_jpeg_batch(paths, self.img_wh)}

    def epoch_batches(self, batch_size: int, shuffle: bool = True, drop_last: bool = True):
        order = self.rng.permutation(len(self)) if shuffle else np.arange(len(self))
        end = (len(order) // batch_size) * batch_size if drop_last else len(order)
        for start in range(0, end, batch_size):
            yield self.sample_batch(order[start:start + batch_size])


def _crop_rgb_np(image, bbox_centre, bbox_wh, out_wh, scale_factor):
    """Host-side crop for eval preprocessing (square bbox, scale + resize).

    :return: (resized crop, scale, translation) with crop px = scale·px + trans.
    """
    h, w = image.shape[:2]
    half = bbox_wh * scale_factor / 2.0
    cy, cx = bbox_centre
    y1, y2 = int(round(cy - half)), int(round(cy + half))
    x1, x2 = int(round(cx - half)), int(round(cx + half))
    pad_y1, pad_x1 = max(0, -y1), max(0, -x1)
    pad_y2, pad_x2 = max(0, y2 - h), max(0, x2 - w)
    cropped = image[max(0, y1) : min(h, y2), max(0, x1) : min(w, x2)]
    if any((pad_y1, pad_y2, pad_x1, pad_x2)):
        widths = [(pad_y1, pad_y2), (pad_x1, pad_x2)] + [(0, 0)] * (image.ndim - 2)
        cropped = np.pad(cropped, widths)
    interp = cv2.INTER_LINEAR if image.ndim == 3 else cv2.INTER_NEAREST
    resized = cv2.resize(cropped, (out_wh, out_wh), interpolation=interp)
    scale = out_wh / (2.0 * half)
    trans = np.array([out_wh / 2.0 - scale * cx, out_wh / 2.0 - scale * cy])
    return resized, scale, trans


class SSP3DEvalDataset:
    """SSP-3D evaluation set: images, silhouettes and labels.npz."""

    def __init__(self, ssp3d_dir_path: str, config: HumaniflowConfig,
                 visible_joints_threshold: Optional[float] = None):
        self.images_dir = os.path.join(ssp3d_dir_path, "images")
        self.silhouettes_dir = os.path.join(ssp3d_dir_path, "silhouettes")
        data = np.load(os.path.join(ssp3d_dir_path, "labels.npz"))
        self.frame_fnames = data["fnames"]
        self.body_shapes = data["shapes"]
        self.body_poses = data["poses"]
        self.keypoints = data["joints2D"]
        self.bbox_centres = data["bbox_centres"]
        self.bbox_whs = data["bbox_whs"]
        self.genders = data["genders"]
        self.img_wh = config.DATA.PROXY_REP_SIZE
        self.bbox_scale_factor = config.DATA.BBOX_SCALE_FACTOR
        self.visible_joints_threshold = visible_joints_threshold

    def __len__(self):
        return len(self.frame_fnames)

    def __getitem__(self, index: int) -> dict:
        fname = str(self.frame_fnames[index])
        image = cv2.cvtColor(cv2.imread(os.path.join(self.images_dir, fname)), cv2.COLOR_BGR2RGB)
        keypoints = np.copy(self.keypoints[index])
        conf = keypoints[:, 2]

        image, scale, trans = _crop_rgb_np(
            image, self.bbox_centres[index], self.bbox_whs[index], self.img_wh, self.bbox_scale_factor,
        )
        kp = keypoints[:, :2] * scale + trans
        if self.visible_joints_threshold is not None:
            vis = conf > self.visible_joints_threshold
            vis[[0, 1, 2, 3, 4, 5, 6, 11, 12]] = True  # gate appendages only
        else:
            vis = np.ones(kp.shape[0], bool)

        silhouette = cv2.imread(os.path.join(self.silhouettes_dir, fname), 0)
        silhouette, _, _ = _crop_rgb_np(
            silhouette, self.bbox_centres[index], self.bbox_whs[index], self.img_wh, self.bbox_scale_factor,
        )
        return {
            "image": np.ascontiguousarray(image),  # (wh, wh, 3) uint8
            "input_joints2D": kp.astype(np.int16).astype(np.float32),
            "input_joints2D_vis": vis,
            "shape": self.body_shapes[index].astype(np.float32),
            "pose": self.body_poses[index].astype(np.float32),
            "silhouette": (silhouette != 0).astype(np.uint8),
            "joints2D": kp.astype(np.float32),
            "fname": fname,
            "gender": str(self.genders[index]),
        }


class PW3DEvalDataset:
    """3DPW evaluation set over preprocessed cropped frames."""

    def __init__(self, pw3d_dir_path: str, config: HumaniflowConfig, extreme_crop_scale=None,
                 visible_joints_threshold: Optional[float] = None, threshold_hip_joints: bool = False):
        if extreme_crop_scale is None:
            self.cropped_frames_dir = os.path.join(pw3d_dir_path, "cropped_frames")
            self.keypoints = np.load(os.path.join(pw3d_dir_path, "hrnet_results_centred.npy"))
        else:
            self.cropped_frames_dir = os.path.join(pw3d_dir_path, f"extreme_cropped_{extreme_crop_scale}_frames")
            self.keypoints = np.load(
                os.path.join(pw3d_dir_path, f"extreme_cropped_{extreme_crop_scale}_hrnet_results_centred.npy")
            )
        data = np.load(os.path.join(pw3d_dir_path, "3dpw_test.npz"))
        self.frame_fnames = data["imgname"]
        self.pose = data["pose"]
        self.shape = data["shape"]
        self.gender = data["gender"]
        if extreme_crop_scale is None:
            self.joints2D = data["joints2D_coco"]
        else:
            self.joints2D = np.load(
                os.path.join(pw3d_dir_path, f"extreme_cropped_{extreme_crop_scale}_joints2D.npy")
            )
        self.img_wh = config.DATA.PROXY_REP_SIZE
        self.visible_joints_threshold = visible_joints_threshold
        self.threshold_hip_joints = threshold_hip_joints

    def __len__(self):
        return len(self.frame_fnames)

    def __getitem__(self, index: int) -> dict:
        fname = str(self.frame_fnames[index])
        image = cv2.cvtColor(cv2.imread(os.path.join(self.cropped_frames_dir, fname)), cv2.COLOR_BGR2RGB)
        oh, ow = image.shape[:2]
        if oh != ow:
            raise ValueError(f"{fname}: cropped frame is {ow}x{oh}, not square")
        image = cv2.resize(image, (self.img_wh, self.img_wh), interpolation=cv2.INTER_LINEAR)

        kp = self.keypoints[index]  # (17, 3) HRNet detections
        conf = kp[:, 2]
        kp = kp[:, :2] * np.array([self.img_wh / ow, self.img_wh / oh])
        if self.visible_joints_threshold is not None:
            vis = conf > self.visible_joints_threshold
            if not self.threshold_hip_joints:
                vis[[0, 1, 2, 3, 4, 5, 6, 11, 12]] = True
            else:
                vis[[0, 1, 2, 3, 4, 5, 6]] = True
        else:
            vis = np.ones(kp.shape[0], bool)

        j2d = self.joints2D[index]  # (17, 3) ground truth
        j2d_conf = j2d[:, 2]
        j2d = j2d[:, :2] * np.array([self.img_wh / ow, self.img_wh / oh])
        j2d_vis = j2d_conf > (self.visible_joints_threshold or 0.0)
        j2d_vis[[1, 2, 3, 4]] = j2d_conf[[1, 2, 3, 4]] > 0.1  # face joints

        return {
            "image": np.ascontiguousarray(image),
            "input_joints2D": np.round(kp).astype(np.int16).astype(np.float32),
            "input_joints2D_vis": vis,
            "pose": self.pose[index].astype(np.float32),
            "shape": self.shape[index].astype(np.float32),
            "fname": fname,
            "joints2D": j2d.astype(np.float32),
            "joints2D_visib": j2d_vis,
            "gender": str(self.gender[index]),
        }


def batch_iterator(dataset, batch_size: int) -> Iterator[dict]:
    """Stack __getitem__ dicts into numpy batches (arrays stacked, strings
    listed)."""
    for start in range(0, len(dataset), batch_size):
        items = [dataset[i] for i in range(start, min(start + batch_size, len(dataset)))]
        batch = {}
        for k in items[0]:
            vals = [it[k] for it in items]
            batch[k] = vals if isinstance(vals[0], str) else np.stack(vals)
        yield batch


def load_opt_initialise_data_from_pred_output(pred_image_dir: str, pred_output_dir: str) -> dict:
    """Stack the per-image `<stem>_pred.npz` dumps of the predict stage
    (pipelines/predict.py::save_pred_output) for the images of
    pred_image_dir (.png, .jpg, .jpeg, sorted by name): {"fnames": [...],
    key: (N, ...) numpy array for every key of the dumps}."""
    fnames = sorted(f for f in os.listdir(pred_image_dir) if f.endswith((".png", ".jpg", ".jpeg")))
    arrays = {}
    for fname in fnames:
        with np.load(os.path.join(pred_output_dir, os.path.splitext(fname)[0] + "_pred.npz")) as npz:
            for k in npz.files:
                arrays.setdefault(k, []).append(npz[k])
    return {"fnames": fnames, **{k: np.stack(v) for k, v in arrays.items()}}
