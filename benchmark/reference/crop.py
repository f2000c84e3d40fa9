"""The axis-aligned affine crop: aspect-matched person box → output size,
bilinear resample with half-pixel centres, zero outside the source; the
joints mapped by the same affine."""

import torch


def crop_affine(output_wh, rgb, bbox_centres, bbox_heights, bbox_widths, scale_factor: float, joints2d=None):
    """Crop NHWC rgb (B, H, W, C) around boxes (centres (B, 2) as (y, x)) to
    output_wh (width, height).  Returns (crops, joints2d mapped, scale, trans)."""
    ow, oh = float(output_wh[0]), float(output_wh[1])
    aspect = oh / ow
    widths = torch.where(bbox_heights > bbox_widths * aspect, bbox_heights / aspect, bbox_widths)
    heights = torch.where(bbox_heights < bbox_widths * aspect, widths * aspect, bbox_heights)
    heights, widths = heights * scale_factor, widths * scale_factor
    scale = torch.stack([ow / widths, oh / heights], dim=-1)
    trans = torch.tensor([ow * 0.5, oh * 0.5], device=scale.device) - scale * bbox_centres[:, [1, 0]]
    xs = torch.arange(int(ow), dtype=torch.float32, device=scale.device)
    ys = torch.arange(int(oh), dtype=torch.float32, device=scale.device)
    src_x = (xs[None] + 0.5 - trans[:, 0, None]) / scale[:, 0, None] - 0.5
    src_y = (ys[None] + 0.5 - trans[:, 1, None]) / scale[:, 1, None] - 0.5
    my = _bilinear_matrix(src_y, rgb.shape[1])
    mx = _bilinear_matrix(src_x, rgb.shape[2])
    out = torch.einsum("bpw,bowc->bopc", mx, torch.einsum("boh,bhwc->bowc", my, rgb.float()))
    joints = None if joints2d is None else joints2d * scale[:, None, :] + trans[:, None, :]
    return out, joints, scale, trans


def _bilinear_matrix(src, size: int):
    """(B, O, size) weights of the source taps of each output; taps out of
    range weigh nothing."""
    ar = torch.arange(size, device=src.device)
    x0 = torch.floor(src)
    w1 = (src - x0)[..., None]
    i0 = x0.to(torch.int64)[..., None]
    return ((i0 == ar) * (1.0 - w1) + ((i0 + 1) == ar) * w1).to(torch.float32)
