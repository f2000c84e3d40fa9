"""Synthetic-training-data augmentation: SMPL shape, camera, lighting, RGB
and proxy-representation corruption.

The PyTorch counterpart of `humaniflow_tpu/data/augmentation.py`: every
"loop over the batch and maybe occlude" of the reference is a broadcast mask
select.  Every random number comes from one `Draws` source, taken in the
order in which the JAX functions use their keys, so a test can replay the
numbers JAX drew (a source whose normal / uniform / randint return them).
"""

import torch

from ..configs.defaults import ProxyRepAugment, RgbAugment
from .label_conversions import TWENTYFOUR_PART_SEG_TO_COCO_JOINTS_MAP


class Draws:
    """The source of every random number of the synthetic-data path: a
    torch.Generator, on the device the numbers are made on."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def normal(self, shape) -> torch.Tensor:
        """Standard normal float32 of `shape`."""
        return torch.randn(tuple(shape), generator=self.generator, device=self.generator.device)

    def uniform(self, shape, lo: float = 0.0, hi: float = 1.0) -> torch.Tensor:
        """Uniform float32 in [lo, hi) of `shape`."""
        u = torch.rand(tuple(shape), generator=self.generator, device=self.generator.device)
        return u * (hi - lo) + lo

    def randint(self, shape, lo: int, hi: int) -> torch.Tensor:
        """Uniform int64 in [lo, hi) of `shape`."""
        return torch.randint(lo, hi, tuple(shape), generator=self.generator, device=self.generator.device)


# ---------------------------------------------------------------- SMPL shape


def normal_sample_shape(draws: Draws, batch_size: int, mean_shape, std_vector):
    """Gaussian shapes (B, nb) around mean_shape."""
    return mean_shape + draws.normal((batch_size, mean_shape.shape[0])) * std_vector


def uniform_sample_shape(draws: Draws, batch_size: int, mean_shape, delta_betas_range):
    """Shapes (B, nb): mean_shape plus a uniform delta in delta_betas_range."""
    return mean_shape + draws.uniform((batch_size, mean_shape.shape[0]), *delta_betas_range)


# ------------------------------------------------------------------- camera


def augment_cam_t(draws: Draws, mean_cam_t, xy_std=0.05, delta_z_range=(-0.5, 0.5)):
    """Camera translations (B, 3): Gaussian xy jitter, uniform z delta."""
    b = mean_cam_t.shape[0]
    dxy = draws.normal((b, 2)) * xy_std
    dz = draws.uniform((b,), *delta_z_range)
    return torch.cat([mean_cam_t[:, :2] + dxy, (mean_cam_t[:, 2] + dz)[:, None]], dim=-1)


# ----------------------------------------------------------------- lighting


def augment_light_t(draws: Draws, batch_size: int, loc_r_range=(0.05, 3.0)):
    """Point-light locations (B, 3): uniform direction × uniform radius."""
    direction = draws.normal((batch_size, 3))
    direction = direction / torch.linalg.norm(direction, dim=-1, keepdim=True)
    return direction * draws.uniform((batch_size, 1), *loc_r_range)


def augment_light_colour(draws: Draws, batch_size: int, ambient_intensity_range=(0.2, 0.8),
                         diffuse_intensity_range=(0.2, 0.8), specular_intensity_range=(0.2, 0.8)):
    """White-light intensities, (B, 3) each."""
    return {
        name: draws.uniform((batch_size, 1), *rng).expand(batch_size, 3)
        for name, rng in (("ambient_color", ambient_intensity_range), ("diffuse_color", diffuse_intensity_range),
                          ("specular_color", specular_intensity_range))
    }


# -------------------------------------------------- half/box occlusion masks


def _row_col_ids(b, h, w, device):
    rows = torch.arange(h, device=device)[None, :, None].expand(b, h, w)
    cols = torch.arange(w, device=device)[None, None, :].expand(b, h, w)
    return rows, cols


def _half_occlusion(draws: Draws, b, wh, prob, jitter_div):
    """(apply (B,), cut (B,)) of a half-image occlusion."""
    apply = draws.uniform((b,)) < prob
    jit = wh // jitter_div
    return apply, wh // 2 + draws.randint((b,), -jit, jit)


def _mask_image(img, mask):
    if img.dim() == 4:
        mask = mask[..., None]
    return torch.where(mask, torch.zeros((), dtype=img.dtype, device=img.device), img)


def random_occlude_bottom_half(draws: Draws, img, joints2d, joints2d_vis, prob):
    """img: (B, H, W) seg or (B, H, W, C) RGB; occludes the rows >= cut."""
    b, h, w = img.shape[:3]
    apply, cut = _half_occlusion(draws, b, h, prob, 5)
    rows, _ = _row_col_ids(b, h, w, img.device)
    img = _mask_image(img, apply[:, None, None] & (rows >= cut[:, None, None]))
    if joints2d is not None:
        joints2d_vis = joints2d_vis & ~(apply[:, None] & (joints2d[..., 1] > cut[:, None]))
    return img, joints2d, joints2d_vis


def random_occlude_top_half(draws: Draws, img, joints2d, joints2d_vis, prob):
    b, h, w = img.shape[:3]
    apply, cut = _half_occlusion(draws, b, h, prob, 5)
    rows, _ = _row_col_ids(b, h, w, img.device)
    img = _mask_image(img, apply[:, None, None] & (rows < cut[:, None, None]))
    if joints2d is not None:
        joints2d_vis = joints2d_vis & ~(apply[:, None] & (joints2d[..., 1] < cut[:, None]))
    return img, joints2d, joints2d_vis


def random_occlude_vertical_half(draws: Draws, img, joints2d, joints2d_vis, prob):
    b, h, w = img.shape[:3]
    apply, cut = _half_occlusion(draws, b, w, prob, 30)
    left_side = draws.uniform((b,)) > 0.5
    _, cols = _row_col_ids(b, h, w, img.device)
    occl_cols = torch.where(left_side[:, None, None], cols < cut[:, None, None], cols >= cut[:, None, None])
    img = _mask_image(img, apply[:, None, None] & occl_cols)
    if joints2d is not None:
        occl_j = torch.where(left_side[:, None], joints2d[..., 0] < cut[:, None], joints2d[..., 0] > cut[:, None])
        joints2d_vis = joints2d_vis & ~(apply[:, None] & occl_j)
    return img, joints2d, joints2d_vis


def random_occlude_box(draws: Draws, seg, prob, box_dim):
    """Zero a box of side box_dim near the image centre."""
    b, h, w = seg.shape
    apply = draws.uniform((b,)) < prob
    cx = draws.uniform((b,), h / 2 - 0.15 * h, h / 2 + 0.15 * h)
    cy = draws.uniform((b,), w / 2 - 0.15 * w, w / 2 + 0.15 * w)
    rows, cols = _row_col_ids(b, h, w, seg.device)
    in_box = (
        (rows >= (cx - box_dim / 2)[:, None, None]) & (rows < (cx + box_dim / 2)[:, None, None])
        & (cols >= (cy - box_dim / 2)[:, None, None]) & (cols < (cy + box_dim / 2)[:, None, None])
    )
    return _mask_image(seg, apply[:, None, None] & in_box)


# ---------------------------------------------------------- joint corruption


def random_joints2d_deviation(draws: Draws, joints2d, delta_j2d_dev_range=(-5, 5),
                              delta_j2d_hip_dev_range=(-15, 15)):
    """Per-joint uniform positional noise; the hips (11, 12) get their own range."""
    b, k = joints2d.shape[:2]
    dev = draws.uniform((b, k, 2), *delta_j2d_dev_range)
    hip_dev = draws.uniform((b, k, 2), *delta_j2d_hip_dev_range)
    is_hip = torch.zeros((k,), dtype=torch.bool, device=joints2d.device)
    is_hip[[11, 12]] = True
    return joints2d + torch.where(is_hip[None, :, None], hip_dev, dev)


def random_swap_joints2d(draws: Draws, joints2d, joints_to_swap, swap_probability=0.1):
    """Left/right confusion of the joint pairs joints_to_swap."""
    b = joints2d.shape[0]
    for a, c in joints_to_swap:
        apply = (draws.uniform((b,)) < swap_probability)[:, None]
        ja, jc = joints2d[:, a], joints2d[:, c]
        joints2d = joints2d.clone()
        joints2d[:, a] = torch.where(apply, jc, ja)
        joints2d[:, c] = torch.where(apply, ja, jc)
    return joints2d


def random_remove_joints2d(draws: Draws, joints2d_vis, joints_to_remove, prob=0.1):
    b = joints2d_vis.shape[0]
    joints2d_vis = joints2d_vis.clone()
    for joint in joints_to_remove:
        joints2d_vis[:, joint] &= ~(draws.uniform((b,)) < prob)
    return joints2d_vis


def random_remove_bodyparts(draws: Draws, seg, classes_to_remove, probs_to_remove, joints2d_vis,
                            prob_to_remove_joints):
    """Remove DensePose part classes from the seg; a removed appendage part
    may also hide its COCO joint."""
    b = seg.shape[0]
    if joints2d_vis is not None:
        joints2d_vis = joints2d_vis.clone()
    for cls, prob in zip(classes_to_remove, probs_to_remove):
        apply = draws.uniform((b,)) < prob
        seg = _mask_image(seg, apply[:, None, None] & (seg == cls))
        if joints2d_vis is not None and cls in TWENTYFOUR_PART_SEG_TO_COCO_JOINTS_MAP:
            joint = TWENTYFOUR_PART_SEG_TO_COCO_JOINTS_MAP[cls]
            joints2d_vis[:, joint] &= ~(apply & (draws.uniform((b,)) < prob_to_remove_joints))
    return seg, joints2d_vis


_LEGS = (5, 6, 7, 8, 9, 10, 11, 12, 13, 14)
_LEGS_ARMS = (3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 19, 20, 21, 22)


def random_extreme_crop(draws: Draws, seg, extreme_crop_probability=0.05):
    """Remove the legs (or legs and arms) part classes to simulate extreme crops."""
    r = draws.uniform((seg.shape[0],))
    do_legs = r < extreme_crop_probability * 0.5
    do_legs_arms = (r > extreme_crop_probability * 0.5) & (r < extreme_crop_probability)
    legs = torch.isin(seg, torch.tensor(_LEGS, device=seg.device))
    legs_arms = torch.isin(seg, torch.tensor(_LEGS_ARMS, device=seg.device))
    seg = _mask_image(seg, do_legs[:, None, None] & legs)
    return _mask_image(seg, do_legs_arms[:, None, None] & legs_arms)


# -------------------------------------------------------------------- suites


def augment_proxy_representation(draws: Draws, seg, joints2d, joints2d_vis, cfg: ProxyRepAugment):
    """The proxy-representation corruption pipeline."""
    seg, joints2d_vis = random_remove_bodyparts(
        draws, seg, cfg.REMOVE_PARTS_CLASSES, cfg.REMOVE_PARTS_PROBS, joints2d_vis,
        cfg.REMOVE_APPENDAGE_JOINTS_PROB,
    )
    seg = random_occlude_box(draws, seg, cfg.OCCLUDE_BOX_PROB, cfg.OCCLUDE_BOX_DIM)
    joints2d = random_swap_joints2d(draws, joints2d, cfg.JOINTS_TO_SWAP, cfg.JOINTS_SWAP_PROB)
    joints2d = random_joints2d_deviation(draws, joints2d, cfg.DELTA_J2D_DEV_RANGE, cfg.DELTA_J2D_DEV_RANGE)
    joints2d_vis = random_remove_joints2d(draws, joints2d_vis, cfg.REMOVE_JOINTS_INDICES, cfg.REMOVE_JOINTS_PROB)
    seg, joints2d, joints2d_vis = random_occlude_bottom_half(draws, seg, joints2d, joints2d_vis,
                                                             cfg.OCCLUDE_BOTTOM_PROB)
    seg, joints2d, joints2d_vis = random_occlude_top_half(draws, seg, joints2d, joints2d_vis, cfg.OCCLUDE_TOP_PROB)
    seg, joints2d, joints2d_vis = random_occlude_vertical_half(draws, seg, joints2d, joints2d_vis,
                                                               cfg.OCCLUDE_VERTICAL_PROB)
    return seg, joints2d, joints2d_vis


def random_pixel_noise_per_channel(draws: Draws, rgb, noise_factor=0.2):
    """rgb (B, H, W, 3) in [0, 1] times a uniform per-channel factor, clipped above at 1."""
    noise = draws.uniform((rgb.shape[0], 1, 1, 3), 1 - noise_factor, 1 + noise_factor)
    return torch.clamp(rgb * noise, max=1.0)


def augment_rgb(draws: Draws, rgb, joints2d, joints2d_vis, cfg: RgbAugment):
    """RGB half occlusions and per-channel pixel noise; rgb is NHWC."""
    rgb, joints2d, joints2d_vis = random_occlude_bottom_half(draws, rgb, joints2d, joints2d_vis,
                                                             cfg.OCCLUDE_BOTTOM_PROB)
    rgb, joints2d, joints2d_vis = random_occlude_top_half(draws, rgb, joints2d, joints2d_vis, cfg.OCCLUDE_TOP_PROB)
    rgb, joints2d, joints2d_vis = random_occlude_vertical_half(draws, rgb, joints2d, joints2d_vis,
                                                               cfg.OCCLUDE_VERTICAL_PROB)
    return random_pixel_noise_per_channel(draws, rgb, cfg.PIXEL_CHANNEL_NOISE), joints2d, joints2d_vis
