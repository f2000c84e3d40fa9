"""Canny edge detection as fixed-weight convolutions.

The PyTorch counterpart of `humaniflow_tpu/models/canny.py`: separable
Gaussian blur (depthwise conv) → Sobel gradients of the channel-mean →
orientation-binned non-max suppression (all 8 directional filters in one
conv) → threshold.  Takes and returns NHWC, as the JAX detector does; the
convolutions run in full float32 (no TF32).
"""

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from .resnet import fp32_convolutions


def _gaussian_window(size: int, std: float) -> np.ndarray:
    n = np.arange(size) - (size - 1) / 2.0
    w = np.exp(-0.5 * (n / std) ** 2)
    return w / w.sum()


_SOBEL_X = np.array([[1, 0, -1], [2, 0, -2], [1, 0, -1]], np.float32)

# 8 directional difference filters, (8, 3, 3)
_DIR_FILTERS = np.array(
    [
        [[0, 0, 0], [0, 1, -1], [0, 0, 0]],
        [[0, 0, 0], [0, 1, 0], [0, 0, -1]],
        [[0, 0, 0], [0, 1, 0], [0, -1, 0]],
        [[0, 0, 0], [0, 1, 0], [-1, 0, 0]],
        [[0, 0, 0], [-1, 1, 0], [0, 0, 0]],
        [[-1, 0, 0], [0, 1, 0], [0, 0, 0]],
        [[0, -1, 0], [0, 1, 0], [0, 0, 0]],
        [[0, 0, -1], [0, 1, 0], [0, 0, 0]],
    ],
    np.float32,
)


@dataclass(frozen=True)
class CannyEdgeDetector:
    non_max_suppression: bool = True
    gaussian_filter_std: float = 1.0
    gaussian_filter_size: int = 5
    threshold: float = 0.2

    def __call__(self, img: torch.Tensor) -> dict:
        """:param img: (B, H, W, C) NHWC image in [0, 1].
        :return: dict with blurred_img (B,H,W,C), grad_magnitude /
            grad_orientation / thresholded_grad_magnitude (B,H,W,1), and with
            NMS also thin_edges / thresholded_thin_edges (B,H,W,1)."""
        with fp32_convolutions():
            return self._detect(img)

    def _detect(self, img):
        c = img.shape[-1]
        kw = dict(dtype=img.dtype, device=img.device)
        x = img.permute(0, 3, 1, 2)
        g = torch.tensor(_gaussian_window(self.gaussian_filter_size, self.gaussian_filter_std), **kw)
        pad = self.gaussian_filter_size // 2
        size = self.gaussian_filter_size
        blurred = F.conv2d(x, g.reshape(1, 1, 1, size).expand(c, 1, 1, size), padding=(0, pad), groups=c)
        blurred = F.conv2d(blurred, g.reshape(1, 1, size, 1).expand(c, 1, size, 1), padding=(pad, 0), groups=c)

        # channel-mean then Sobel (linear, so equal to the mean of per-channel Sobel)
        mean_blurred = blurred.mean(dim=1, keepdim=True)
        sx = torch.tensor(_SOBEL_X, **kw)[None, None]
        grad_x = F.conv2d(mean_blurred, sx, padding=1)
        grad_y = F.conv2d(mean_blurred, sx.transpose(-1, -2), padding=1)

        grad_magnitude = torch.sqrt(grad_x**2 + grad_y**2 + 1e-20)
        grad_orientation = torch.atan2(grad_y, grad_x) * (180.0 / np.pi) + 180.0
        grad_orientation = torch.round(grad_orientation / 45.0) * 45.0

        nhwc = lambda t: t.permute(0, 2, 3, 1)  # noqa: E731
        out = {
            "blurred_img": nhwc(blurred),
            "grad_magnitude": nhwc(grad_magnitude),
            "grad_orientation": nhwc(grad_orientation),
            "thresholded_grad_magnitude": nhwc(
                torch.where(grad_magnitude < self.threshold, 0.0, grad_magnitude)
            ),
        }
        if self.non_max_suppression:
            directional = F.conv2d(grad_magnitude, torch.tensor(_DIR_FILTERS, **kw)[:, None], padding=1)
            pos_idx = torch.remainder(grad_orientation[:, 0] / 45.0, 8)  # (B, H, W)
            suppress = torch.zeros_like(pos_idx, dtype=torch.bool)
            for pos_i in range(4):
                neg_i = pos_i + 4
                oriented = (pos_idx == pos_i) | (pos_idx == neg_i)
                is_max = torch.minimum(directional[:, pos_i], directional[:, neg_i]) > 0.0
                suppress = suppress | (oriented & ~is_max)
            thin = torch.where(suppress[:, None], 0.0, grad_magnitude)
            out["thin_edges"] = nhwc(thin)
            out["thresholded_thin_edges"] = nhwc(torch.where(thin < self.threshold, 0.0, thin))
        return out
