"""The 18-channel proxy: Canny edges of the image and 17 joint heatmaps.

Canny: separable Gaussian blur → Sobel gradients of the channel mean →
orientation-binned non-max suppression → threshold.  Heatmaps: Gaussians of
std HEATMAP_GAUSSIAN_STD at each joint, zeroed for appendage joints whose
confidence is at or below the visibility threshold.
"""

import numpy as np
import torch
import torch.nn.functional as F

_SOBEL_X = np.array([[1, 0, -1], [2, 0, -2], [1, 0, -1]], np.float32)
_DIR_FILTERS = np.array([
    [[0, 0, 0], [0, 1, -1], [0, 0, 0]], [[0, 0, 0], [0, 1, 0], [0, 0, -1]],
    [[0, 0, 0], [0, 1, 0], [0, -1, 0]], [[0, 0, 0], [0, 1, 0], [-1, 0, 0]],
    [[0, 0, 0], [-1, 1, 0], [0, 0, 0]], [[-1, 0, 0], [0, 1, 0], [0, 0, 0]],
    [[0, -1, 0], [0, 1, 0], [0, 0, 0]], [[0, 0, -1], [0, 1, 0], [0, 0, 0]],
], np.float32)


def canny(img, data_cfg):
    """Thresholded thin edges (B, H, W, 1) of NHWC img in [0, 1]."""
    size, std, thr = data_cfg["EDGE_GAUSSIAN_SIZE"], data_cfg["EDGE_GAUSSIAN_STD"], data_cfg["EDGE_THRESHOLD"]
    kw = dict(dtype=img.dtype, device=img.device)
    c = img.shape[-1]
    n = np.arange(size) - (size - 1) / 2.0
    win = np.exp(-0.5 * (n / std) ** 2)
    g = torch.tensor(win / win.sum(), **kw)
    pad = size // 2
    x = img.permute(0, 3, 1, 2)
    x = F.conv2d(x, g.reshape(1, 1, 1, size).expand(c, 1, 1, size), padding=(0, pad), groups=c)
    x = F.conv2d(x, g.reshape(1, 1, size, 1).expand(c, 1, size, 1), padding=(pad, 0), groups=c)
    mean = x.mean(dim=1, keepdim=True)
    sx = torch.tensor(_SOBEL_X, **kw)[None, None]
    gx = F.conv2d(mean, sx, padding=1)
    gy = F.conv2d(mean, sx.transpose(-1, -2), padding=1)
    mag = torch.sqrt(gx ** 2 + gy ** 2 + 1e-20)
    orient = torch.round((torch.atan2(gy, gx) * (180.0 / np.pi) + 180.0) / 45.0) * 45.0
    if not data_cfg["EDGE_NMS"]:
        return torch.where(mag < thr, 0.0, mag).permute(0, 2, 3, 1)
    directional = F.conv2d(mag, torch.tensor(_DIR_FILTERS, **kw)[:, None], padding=1)
    pos = torch.remainder(orient[:, 0] / 45.0, 8)
    suppress = torch.zeros_like(pos, dtype=torch.bool)
    for i in range(4):
        oriented = (pos == i) | (pos == i + 4)
        suppress = suppress | (oriented & ~(torch.minimum(directional[:, i], directional[:, i + 4]) > 0.0))
    thin = torch.where(suppress[:, None], 0.0, mag)
    return torch.where(thin < thr, 0.0, thin).permute(0, 2, 3, 1)


def heatmaps(joints2d, size: int, std: float):
    """(B, K, size, size) Gaussian heatmaps of (B, K, 2) joints given as (x, y)."""
    grid = torch.arange(size, dtype=torch.float32, device=joints2d.device)
    u = joints2d[..., 0, None, None].float()
    v = joints2d[..., 1, None, None].float()
    return torch.exp(-(((grid[None, None, None, :] - u) / std) ** 2) / 2
                     - (((grid[None, None, :, None] - v) / std) ** 2) / 2)


def build_proxy(image, joints2d, joints2d_conf, data_cfg, visib_threshold: float = 0.75):
    """(B, size, size, 18): edges, then the 17 heatmaps; head and torso joints
    (0-6) are always kept."""
    hm = heatmaps(joints2d, data_cfg["PROXY_REP_SIZE"], data_cfg["HEATMAP_GAUSSIAN_STD"])
    if joints2d_conf is not None:
        vis = joints2d_conf > visib_threshold
        vis[:, :7] = True
        hm = hm * vis[:, :, None, None]
    return torch.cat([canny(image.float(), data_cfg), hm.permute(0, 2, 3, 1)], dim=-1)
