"""Batched image-space ops: bounding boxes and the axis-aligned affine crop.

The PyTorch counterpart of the crop half of `humaniflow_tpu/data/image_ops.py`
(reference `utils/image_utils.py`).  Images are NHWC tensors, joints (x, y).
The crop keeps the JAX package's separable resample: the affine is scale and
translation only, so rows and columns resample independently, each as one
batched matmul with a (B, out, in) interpolation matrix.  Source coordinates
follow align_corners=False (half-pixel centres); nearest sampling keeps
`round`'s semantics, ties to even as jnp.round.
"""

from typing import Tuple

import torch

BIG = 1e9


def convert_bbox_corners_to_centre_hw(bbox_corners: torch.Tensor):
    """(B, 4) [y1, x1, y2, x2] → centres (B, 2) [y, x], heights (B,), widths (B,)."""
    centres = torch.stack(
        [(bbox_corners[:, 0] + bbox_corners[:, 2]) / 2.0, (bbox_corners[:, 1] + bbox_corners[:, 3]) / 2.0],
        dim=-1,
    )
    return centres, bbox_corners[:, 2] - bbox_corners[:, 0], bbox_corners[:, 3] - bbox_corners[:, 1]


def convert_bbox_centre_hw_to_corners(centre, height, width):
    return torch.stack(
        [centre[..., 0] - height / 2.0, centre[..., 1] - width / 2.0,
         centre[..., 0] + height / 2.0, centre[..., 1] + width / 2.0],
        dim=-1,
    )


def bbox_from_silhouette(seg: torch.Tensor) -> torch.Tensor:
    """Corners [y1, x1, y2, x2] of the nonzero region of each (H, W) mask of
    seg (B, H, W), as a masked min/max."""
    b, h, w = seg.shape
    mask = seg != 0
    rows = torch.arange(h, dtype=torch.float32, device=seg.device)[None, :, None].expand(b, h, w)
    cols = torch.arange(w, dtype=torch.float32, device=seg.device)[None, None, :].expand(b, h, w)
    big = torch.tensor(BIG, device=seg.device)
    y1 = torch.where(mask, rows, big).amin(dim=(1, 2))
    x1 = torch.where(mask, cols, big).amin(dim=(1, 2))
    y2 = torch.where(mask, rows, -big).amax(dim=(1, 2))
    x2 = torch.where(mask, cols, -big).amax(dim=(1, 2))
    return torch.stack([y1, x1, y2, x2], dim=-1)


def bbox_from_joints2d(joints2d: torch.Tensor, vis: torch.Tensor) -> torch.Tensor:
    """Corners [y1, x1, y2, x2] from the visible joints (B, K, 2) as (x, y)."""
    big = torch.tensor(BIG, dtype=joints2d.dtype, device=joints2d.device)
    x, y = joints2d[..., 0], joints2d[..., 1]
    x1 = torch.where(vis, x, big).amin(dim=-1)
    y1 = torch.where(vis, y, big).amin(dim=-1)
    x2 = torch.where(vis, x, -big).amax(dim=-1)
    y2 = torch.where(vis, y, -big).amax(dim=-1)
    return torch.stack([y1, x1, y2, x2], dim=-1)


def _interp_matrix(src: torch.Tensor, size: int, mode: str):
    """Per-batch 1-D resampling matrix M (B, O, size), M[b, o, i] the weight
    of source index i for output o, and the in-range mask (B, O).  Taps out
    of range get zero weight (they read pad 0)."""
    ar = torch.arange(size, device=src.device)
    if mode == "nearest":
        idx = torch.round(src).to(torch.int64)
        valid = (idx >= 0) & (idx < size)
        return (idx[..., None] == ar).to(torch.float32), valid
    x0f = torch.floor(src)
    w1 = (src - x0f)[..., None]
    i0 = x0f.to(torch.int64)[..., None]
    m = (i0 == ar) * (1.0 - w1) + ((i0 + 1) == ar) * w1
    valid = (src >= 0.0) & (src <= size - 1.0)
    return m.to(torch.float32), valid


def _separable_sample(img: torch.Tensor, src_xs: torch.Tensor, src_ys: torch.Tensor, mode: str,
                      pad_val: float = 0.0) -> torch.Tensor:
    """Axis-aligned resample of img (B, H, W, C) at source columns src_xs
    (B, OW) and rows src_ys (B, OH) → (B, OH, OW, C)."""
    _, h, w, _ = img.shape
    my, vy = _interp_matrix(src_ys, h, mode)  # (B, OH, H)
    mx, vx = _interp_matrix(src_xs, w, mode)  # (B, OW, W)
    tmp = torch.einsum("boh,bhwc->bowc", my, img.to(my.dtype))
    out = torch.einsum("bpw,bowc->bopc", mx, tmp)
    if pad_val != 0.0:
        valid = vy[:, :, None] & vx[:, None, :]
        out = torch.where(valid[..., None], out, torch.full_like(out, pad_val))
    return out


def _crop_affine_params(bbox_centres, bbox_heights, bbox_widths, output_wh, orig_scale_factor):
    """Aspect match and scale → the forward affine dst = s·src + t in (x, y)
    pixel coordinates, scale (B, 2) and translation (B, 2)."""
    ow, oh = float(output_wh[0]), float(output_wh[1])
    aspect = oh / ow
    widths = torch.where(bbox_heights > bbox_widths * aspect, bbox_heights / aspect, bbox_widths)
    heights = torch.where(bbox_heights < bbox_widths * aspect, widths * aspect, bbox_heights)
    heights = heights * orig_scale_factor
    widths = widths * orig_scale_factor
    scale = torch.stack([ow / widths, oh / heights], dim=-1)
    out_centre = torch.tensor([ow * 0.5, oh * 0.5], dtype=scale.dtype, device=scale.device)
    trans = out_centre - scale * bbox_centres[:, [1, 0]]  # centres are (y, x)
    return scale, trans


def batch_crop_affine(
    output_wh: Tuple[int, int],
    iuv=None,
    joints2d=None,
    rgb=None,
    seg=None,
    bbox_determiner=None,
    bbox_centres=None,
    bbox_heights=None,
    bbox_widths=None,
    bbox_whs=None,
    joints2d_vis=None,
    orig_scale_factor: float = 1.2,
    out_of_frame_pad_val: float = 0.0,
) -> dict:
    """Batched crop-and-resize around person bounding boxes.

    Images are NHWC (B, H, W, C), seg (B, H, W), joints2d (B, K, 2) as (x, y).
    Without given boxes, they come from bbox_determiner, iuv, seg or the
    visible joints, in that order.  Returns the crops at output_wh (width,
    height) and the affine ("crop_scale", "crop_trans")."""
    if bbox_centres is None:
        if bbox_determiner is not None:
            corners = bbox_from_silhouette(bbox_determiner)
        elif iuv is not None:
            corners = bbox_from_silhouette(iuv[..., 0])
        elif seg is not None:
            corners = bbox_from_silhouette(seg)
        else:
            corners = bbox_from_joints2d(joints2d, joints2d_vis)
        bbox_centres, bbox_heights, bbox_widths = convert_bbox_corners_to_centre_hw(corners)
    elif bbox_whs is not None:
        bbox_heights = bbox_whs
        bbox_widths = bbox_whs

    scale, trans = _crop_affine_params(bbox_centres, bbox_heights, bbox_widths, output_wh, orig_scale_factor)
    ow, oh = int(output_wh[0]), int(output_wh[1])
    xs = torch.arange(ow, dtype=torch.float32, device=scale.device)
    ys = torch.arange(oh, dtype=torch.float32, device=scale.device)
    src_xs = (xs[None] + 0.5 - trans[:, 0, None]) / scale[:, 0, None] - 0.5  # (B, OW)
    src_ys = (ys[None] + 0.5 - trans[:, 1, None]) / scale[:, 1, None] - 0.5  # (B, OH)

    out = {"crop_scale": scale, "crop_trans": trans}
    if iuv is not None:
        out["iuv"] = _separable_sample(iuv, src_xs, src_ys, "nearest", out_of_frame_pad_val)
    if rgb is not None:
        out["rgb"] = _separable_sample(rgb, src_xs, src_ys, "bilinear", 0.0)
    if seg is not None:
        out["seg"] = _separable_sample(seg[..., None], src_xs, src_ys, "nearest", 0.0)[..., 0]
    if joints2d is not None:
        out["joints2d"] = joints2d * scale[:, None, :] + trans[:, None, :]
    return out
