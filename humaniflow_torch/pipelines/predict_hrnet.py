"""HRNet keypoint stage of the uncropped-image pipeline.

The PyTorch counterpart of `humaniflow_tpu/pipelines/predict_hrnet.py`
(reference `predict/predict_hrnet.py`): person box → aspect-matched crop to
384×288 → ImageNet normalisation → HRNet-W48 heatmaps → argmax keypoints
rescaled to the crop.  The images go to the device once, one stack per
distinct size; all of them go through one batched HRNet forward, and a
second batched pass runs when the keypoint-box fallback re-crops.

Person boxes come from the caller, from the optional torchvision Mask-RCNN
adapter (`detect_person_bbox_torchvision`, None when torchvision is not
installed, as in the JAX package), or from the keypoint-box fallback: a
whole-image pass finds rough keypoints, the dominant central cluster of the
confident ones gives a box, and the images are cropped again.
"""

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.image_ops import batch_crop_affine
from ..models.hrnet import PoseHighResolutionNet, get_kp_locations_confs_from_heatmaps
from ..utils.device import resolve_device
from ..utils.tracing import count, enabled, span, traced

HRNET_INPUT_WH = (288, 384)  # (width, height)
HRNET_HEATMAP_WH = (72, 96)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def detect_person_bbox_torchvision(image_np: np.ndarray, threshold: float = 0.95):
    """Centre-most person box by torchvision's Mask-RCNN (CPU).

    :param image_np: (H, W, 3) RGB in [0, 1].
    :return: (centre (2,) [y, x], height, width), or None when torchvision is
        not installed or no person clears the threshold."""
    try:
        from torchvision.models.detection import maskrcnn_resnet50_fpn
    except Exception:
        return None
    model = maskrcnn_resnet50_fpn(pretrained=True)
    model.eval()
    with torch.no_grad():
        pred = model([torch.from_numpy(image_np.transpose(2, 0, 1))])[0]
    person = pred["labels"] == 1
    boxes = pred["boxes"][person][pred["scores"][person] > threshold]
    if boxes.shape[0] == 0:
        return None
    boxes = boxes.numpy()  # (N, 4) x1 y1 x2 y2
    centres = np.stack([(boxes[:, 1] + boxes[:, 3]) / 2, (boxes[:, 0] + boxes[:, 2]) / 2], axis=-1)
    h, w = image_np.shape[:2]
    i = int(np.argmin((centres[:, 0] - h / 2) ** 2 + (centres[:, 1] - w / 2) ** 2))
    return centres[i], boxes[i, 3] - boxes[i, 1], boxes[i, 2] - boxes[i, 0]


def bbox_from_keypoints(joints2d: np.ndarray, confs: np.ndarray, conf_threshold: float = 0.5,
                        min_size: float = 64.0):
    """Box (centre [y, x], height, width) of the confident keypoints (x, y);
    a single visible joint gives a min_size box; None when no joint clears
    the threshold."""
    vis = confs > conf_threshold
    if not vis.any():
        return None
    pts = joints2d[vis]
    x1, y1 = pts[:, 0].min(), pts[:, 1].min()
    x2, y2 = pts[:, 0].max(), pts[:, 1].max()
    if x2 - x1 < 1.0 and y2 - y1 < 1.0:
        x2, y2 = x1 + min_size, y1 + min_size
    centre = np.array([(y1 + y2) / 2.0, (x1 + x2) / 2.0], np.float32)
    return centre, max(float(y2 - y1), min_size), max(float(x2 - x1), min_size)


def select_central_keypoint_cluster(joints2d: np.ndarray, confs: np.ndarray, img_h: float, img_w: float,
                                    conf_threshold: float = 0.5, link_factor: float = 0.3) -> np.ndarray:
    """(17,) mask of the confident keypoints in the dominant, most central
    cluster: single-linkage clusters at link distance link_factor·max(H, W);
    the cluster with the most joints wins, ties to the centroid nearest the
    image centre.  Keeps a multi-person whole-image pass from boxing everyone."""
    vis = confs > conf_threshold
    idx = np.where(vis)[0]
    if idx.size <= 1:
        return vis
    pts = joints2d[idx].astype(np.float64)
    thresh = link_factor * max(float(img_h), float(img_w))
    parent = np.arange(idx.size)

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    d2 = ((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
    for i in range(idx.size):
        for j in range(i + 1, idx.size):
            if d2[i, j] < thresh * thresh:
                parent[find(i)] = find(j)
    roots = np.array([find(i) for i in range(idx.size)])
    centre = np.array([img_w / 2.0, img_h / 2.0])
    best_root, best_key = None, None
    for r in np.unique(roots):
        members = roots == r
        key = (int(members.sum()), -float(((pts[members].mean(0) - centre) ** 2).sum()))
        if best_key is None or key > best_key:
            best_root, best_key = r, key
    mask = np.zeros_like(vis)
    mask[idx[roots == best_root]] = True
    return mask


@traced("hrnet.upload")
def _upload(images: Sequence[np.ndarray], device) -> List[Tuple[List[int], torch.Tensor]]:
    """The images grouped by shape, each group stacked on `device` once:
    [(indices, (n, H, W, 3) float32 tensor)]."""
    if enabled() and device.type != "cpu":
        count("h2d_bytes", sum(img.nbytes for img in images))
    groups: Dict[Tuple[int, ...], List[int]] = {}
    for i, img in enumerate(images):
        groups.setdefault(img.shape, []).append(i)
    return [(idxs, torch.stack([torch.as_tensor(images[i], dtype=torch.float32, device=device) for i in idxs]))
            for idxs in groups.values()]


@traced("hrnet.crop")
def _crop_to_hrnet_input(groups, centres, heights, widths, bbox_scale_factor: float,
                         device) -> Tuple[torch.Tensor, np.ndarray, np.ndarray]:
    """Crop every image to HRNET_INPUT_WH, one batched crop per shape group
    of `_upload`.  Returns crops (N, H, W, 3) on `device` and the exact crop
    affine dst_xy = scale·src_xy + trans, scale (N, 2) and trans (N, 2)."""
    n = sum(len(idxs) for idxs, _ in groups)
    crops = torch.empty((n, HRNET_INPUT_WH[1], HRNET_INPUT_WH[0], 3), dtype=torch.float32, device=device)
    scales = np.empty((n, 2), np.float32)
    transes = np.empty((n, 2), np.float32)
    as_t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    for idxs, rgb in groups:
        out = batch_crop_affine(
            HRNET_INPUT_WH, rgb=rgb, bbox_centres=as_t(centres[idxs]), bbox_heights=as_t(heights[idxs]),
            bbox_widths=as_t(widths[idxs]), orig_scale_factor=bbox_scale_factor,
        )
        crops[idxs] = out["rgb"]
        scales[idxs] = out["crop_scale"].cpu().numpy()
        transes[idxs] = out["crop_trans"].cpu().numpy()
    return crops, scales, transes


@torch.inference_mode()
def _hrnet_keypoints(hrnet: PoseHighResolutionNet, crops: torch.Tensor):
    """Normalise → HRNet → argmax decode, one batched forward: keypoints
    (N, 17, 2) in crop pixels and confidences (N, 17), on the crops' device."""
    with span("hrnet.net"):
        mean = torch.tensor(IMAGENET_MEAN, device=crops.device)
        std = torch.tensor(IMAGENET_STD, device=crops.device)
        heatmaps = hrnet((crops - mean) / std)
    with span("hrnet.decode"):
        joints2d, confs = get_kp_locations_confs_from_heatmaps(heatmaps)
        return joints2d * (HRNET_INPUT_WH[0] / HRNET_HEATMAP_WH[0]), confs


@traced("hrnet")
def predict_hrnet_batch(
    hrnet: PoseHighResolutionNet,
    images: Sequence[np.ndarray],
    bboxes: Optional[Sequence[Optional[Tuple]]] = None,
    object_detect_threshold: float = 0.95,
    bbox_scale_factor: float = 1.2,
    use_torchvision_detector: bool = False,
    keypoint_bbox_fallback: bool = True,
    keypoint_conf_threshold: float = 0.5,
    device=None,
) -> Dict:
    """N uncropped images → HRNet keypoints and crop metadata, batched.

    :param images: (H, W, 3) RGB arrays in [0, 1]; sizes may differ.
    :param bboxes: optional per-image (centre [y, x], height, width) or None.
    :param device: default CUDA (raises if unavailable); hrnet must live there.
    :return: joints2D (N, 17, 2) in crop pixels, joints2Dconfs (N, 17) and
        cropped_images (N, 384, 288, 3) as tensors on `device`; bbox_centres
        (N, 2), bbox_heights (N,), bbox_widths (N,) as numpy arrays.
    """
    device = resolve_device(device)
    if hrnet.device.type != device.type:
        raise ValueError(f"hrnet lives on {hrnet.device}, not on {device}")
    n = len(images)
    centres = np.zeros((n, 2), np.float32)
    heights = np.zeros(n, np.float32)
    widths = np.zeros(n, np.float32)
    needs_fallback = []
    for i, image in enumerate(images):
        bbox = bboxes[i] if bboxes is not None else None
        if bbox is None and use_torchvision_detector:
            bbox = detect_person_bbox_torchvision(image, object_detect_threshold)
        if bbox is None:
            h, w = image.shape[:2]
            centres[i] = (h / 2.0, w / 2.0)
            heights[i], widths[i] = float(h), float(w)
            needs_fallback.append(i)
        else:
            centre, height, width = bbox
            centres[i] = np.asarray(centre, np.float32)
            heights[i], widths[i] = float(height), float(width)

    groups = _upload(images, device)
    crops, scales, transes = _crop_to_hrnet_input(groups, centres, heights, widths, bbox_scale_factor, device)
    joints2d, confs = _hrnet_keypoints(hrnet, crops)

    if keypoint_bbox_fallback and needs_fallback:
        with span("hrnet.fallback"):
            # whole-image keypoints back to source pixels through the exact
            # inverse crop affine; the central cluster's box; crop and run again
            j2d_np, confs_np = joints2d.cpu().numpy(), confs.cpu().numpy()
            refined = False
            for i in needs_fallback:
                src_j2d = (j2d_np[i] - transes[i]) / scales[i]
                h_i, w_i = images[i].shape[:2]
                keep = select_central_keypoint_cluster(src_j2d, confs_np[i], h_i, w_i,
                                                       conf_threshold=keypoint_conf_threshold)
                bbox = bbox_from_keypoints(src_j2d, np.where(keep, confs_np[i], 0.0),
                                           conf_threshold=keypoint_conf_threshold)
                if bbox is not None:
                    centres[i] = bbox[0]
                    heights[i], widths[i] = bbox[1], bbox[2]
                    refined = True
            if refined:
                crops, scales, transes = _crop_to_hrnet_input(groups, centres, heights, widths, bbox_scale_factor,
                                                              device)
                joints2d, confs = _hrnet_keypoints(hrnet, crops)

    return {
        "joints2D": joints2d,
        "joints2Dconfs": confs,
        "cropped_images": crops,
        "bbox_centres": centres,
        "bbox_heights": heights,
        "bbox_widths": widths,
    }


def predict_hrnet(hrnet: PoseHighResolutionNet, image: np.ndarray, bbox: Optional[Tuple] = None,
                  object_detect_threshold: float = 0.95, bbox_scale_factor: float = 1.2,
                  use_torchvision_detector: bool = False, keypoint_bbox_fallback: bool = True,
                  device=None) -> Dict:
    """One uncropped image → HRNet keypoints and crop metadata (the batched
    path at N = 1)."""
    out = predict_hrnet_batch(
        hrnet, [image], bboxes=[bbox], object_detect_threshold=object_detect_threshold,
        bbox_scale_factor=bbox_scale_factor, use_torchvision_detector=use_torchvision_detector,
        keypoint_bbox_fallback=keypoint_bbox_fallback, device=device,
    )
    return {
        "joints2D": out["joints2D"][0],
        "joints2Dconfs": out["joints2Dconfs"][0],
        "cropped_image": out["cropped_images"][0],
        "bbox_centre": out["bbox_centres"][0],
        "bbox_height": float(out["bbox_heights"][0]),
        "bbox_width": float(out["bbox_widths"][0]),
    }
