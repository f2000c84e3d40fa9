"""Visualisation: multi-panel point-estimate figures, uncropped composites,
sample grids and per-vertex-uncertainty scatter plots.

The counterpart of `humaniflow_tpu/utils/visualise.py` (reference
`utils/visualise_utils.py`).  Mesh renders come from the renderer on the
renderer's device; figure composition is host-side numpy.  OpenCV (the joint
markers) and matplotlib (the scatter plot) are imported inside the functions
that draw with them: without OpenCV `annotate_joints2d` returns the image
unchanged, as in the JAX package.
"""

import math
from typing import Dict, List, Optional

import numpy as np
import torch

from ..data.image_ops import batch_uncrop_affine
from ..ops.rotation import aa_rotate_translate_points


def _np(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def uncertainty_colourmap(values: np.ndarray, vmin=0.0, vmax=0.2) -> np.ndarray:
    """Jet-like colourmap of per-vertex uncertainty values (V,) → (V, 3)."""
    t = np.clip((values - vmin) / max(vmax - vmin, 1e-9), 0.0, 1.0)
    r = np.clip(1.5 - np.abs(4 * t - 3), 0, 1)
    g = np.clip(1.5 - np.abs(4 * t - 2), 0, 1)
    b = np.clip(1.5 - np.abs(4 * t - 1), 0, 1)
    return np.stack([r, g, b], axis=-1)


def rotated_vertex_views(vertices: torch.Tensor, angles_deg=(90, 180, 270)) -> Dict[str, torch.Tensor]:
    """{"0": vertices, "90": ..., ...}: the (B, V, 3) vertices rotated about
    the y axis by −angle, for multi-view renders."""
    views = {"0": vertices}
    y_axis = torch.tensor([0.0, 1.0, 0.0], dtype=torch.float32, device=vertices.device)
    zero_t = torch.zeros(3, dtype=torch.float32, device=vertices.device)
    for rot in angles_deg:
        views[str(rot)] = aa_rotate_translate_points(vertices, y_axis, -math.radians(rot), zero_t)
    return views


def annotate_joints2d(image: np.ndarray, joints2d: np.ndarray, confs: Optional[np.ndarray] = None,
                      radius: int = 3) -> np.ndarray:
    """Keypoints drawn on an image in [0, 1] (joints with confidence below
    0.3 skipped), with OpenCV; without OpenCV the image is returned as it
    is."""
    try:
        import cv2
    except Exception:
        return image
    img = np.ascontiguousarray((image * 255).astype(np.uint8))
    for j, (x, y) in enumerate(np.asarray(joints2d)):
        if confs is not None and confs[j] < 0.3:
            continue
        if 0 <= int(x) < img.shape[1] and 0 <= int(y) < img.shape[0]:
            cv2.circle(img, (int(x), int(y)), radius, (255, 60, 60), -1)
    return img.astype(np.float32) / 255.0


def render_point_est_visualisation(renderer, vertices_point_est: torch.Tensor, cam_wp: torch.Tensor,
                                   input_image: Optional[np.ndarray] = None,
                                   proxy_image: Optional[np.ndarray] = None,
                                   joints2d: Optional[np.ndarray] = None,
                                   joints2d_confs: Optional[np.ndarray] = None,
                                   tpose_vertices: Optional[torch.Tensor] = None,
                                   vertex_colours=None) -> Dict:
    """Multi-panel point-estimate figure: input | annotated proxy |
    0/90/180/270° renders | T-pose.

    :param vertices_point_est: (B, 6890, 3) flipped vertices on the
        renderer's device; cam_wp (B, 3); vertex_colours (B, 6890, 3) or
        (6890, 3), default grey 0.75.
    :return: {"figure": (B, wh, wh·panels, 3) numpy, "renders": {view:
        (B, wh, wh, 3) numpy}}.
    """
    dev = vertices_point_est.device
    b = vertices_point_est.shape[0]
    cam_wp = torch.as_tensor(cam_wp, dtype=torch.float32, device=dev)
    cam_t = torch.stack([cam_wp[:, 1], cam_wp[:, 2], torch.full_like(cam_wp[:, 0], 2.5)], dim=-1)
    scale = cam_wp[:, [0, 0]]
    views = rotated_vertex_views(vertices_point_est)

    panels: List[np.ndarray] = []
    if input_image is not None:
        panels.append(_np(input_image))
    if proxy_image is not None:
        proxy_rgb = np.repeat(_np(proxy_image)[..., None], 3, axis=-1)
        if joints2d is not None:
            proxy_rgb = np.stack([
                annotate_joints2d(proxy_rgb[i], joints2d[i], None if joints2d_confs is None else joints2d_confs[i])
                for i in range(b)
            ])
        panels.append(proxy_rgb)

    renders = {}
    vf = None if vertex_colours is None else torch.as_tensor(vertex_colours, dtype=torch.float32, device=dev)
    with torch.inference_mode():
        for name, verts in views.items():
            out = renderer(verts, cam_t=cam_t, orthographic_scale=scale,
                           verts_features=vf if vf is not None else torch.ones_like(verts) * 0.75)
            renders[name] = _np(out["rgb_images"])
            panels.append(renders[name])
        if tpose_vertices is not None:
            fixed_cam_t = torch.tensor([[0.0, -0.2, 2.5]], device=dev).expand(b, 3)
            fixed_scale = torch.full((b, 2), 0.95, device=dev)
            out = renderer(tpose_vertices, cam_t=fixed_cam_t, orthographic_scale=fixed_scale,
                           verts_features=vf if vf is not None else torch.ones_like(tpose_vertices) * 0.75)
            renders["tpose"] = _np(out["rgb_images"])
            panels.append(renders["tpose"])
    return {"figure": np.concatenate(panels, axis=2), "renders": renders}


def uncrop_point_est_visualisation(cropped_render_rgb: np.ndarray, cropped_silhouette: np.ndarray, bbox_centres,
                                   bbox_whs, orig_image: np.ndarray, bbox_scale_factor: float = 1.2) -> np.ndarray:
    """Composite cropped mesh renders (B, wh, wh, 3) back onto the original
    images (B, UH, UW, 3) where their silhouettes (B, wh, wh) cover, on the
    CPU; bbox_centres (B, 2) as (y, x), bbox_whs (B,)."""
    uh, uw = orig_image.shape[1:3]
    f32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32)  # noqa: E731
    whs = f32(bbox_whs) * bbox_scale_factor
    crop_wh = cropped_render_rgb.shape[1:3][::-1]
    rgb_uncrop = batch_uncrop_affine(f32(cropped_render_rgb), (uw, uh), f32(bbox_centres), whs, whs, crop_wh)
    sil_uncrop = batch_uncrop_affine(f32(cropped_silhouette)[..., None], (uw, uh), f32(bbox_centres), whs, whs,
                                     cropped_silhouette.shape[1:3][::-1], mode="nearest")
    return np.where(sil_uncrop.numpy() > 0.5, rgb_uncrop.numpy(), np.asarray(orig_image))


def render_samples_visualisation(renderer, vertices_samples: torch.Tensor, cam_wp, num_rows: int = 3,
                                 num_cols: int = 6) -> np.ndarray:
    """Grid of mesh-sample renders (grey, the camera of cam_wp[0]).

    :param vertices_samples: (N, V, 3) flipped, J2D-error-sorted samples on
        the renderer's device; the first num_rows·num_cols are drawn.
    :return: (rows·wh, cols·wh, 3) numpy.
    """
    n = min(num_rows * num_cols, vertices_samples.shape[0])
    verts = vertices_samples[:n]
    cam = _np(cam_wp)
    cam_t = torch.tensor([[float(cam[0, 1]), float(cam[0, 2]), 2.5]], device=verts.device).expand(n, 3)
    scale = torch.tensor([[float(cam[0, 0])] * 2], device=verts.device).expand(n, 2)
    with torch.inference_mode():
        out = renderer(verts, cam_t=cam_t, orthographic_scale=scale, verts_features=torch.ones_like(verts) * 0.75)
    renders = _np(out["rgb_images"])  # (n, wh, wh, 3)
    wh = renders.shape[1]
    grid = np.zeros((num_rows * wh, num_cols * wh, 3), np.float32)
    for i in range(n):
        r, c = divmod(i, num_cols)
        grid[r * wh:(r + 1) * wh, c * wh:(c + 1) * wh] = renders[i]
    return grid


def plot_xyz_vertex_variance(vertices_point_est: np.ndarray, directional_variance: np.ndarray,
                             save_path: Optional[str] = None):
    """Matplotlib scatter of the per-vertex directional std in x, y and z
    panels; saved to save_path (then None is returned) or returned as the
    figure."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    verts = _np(vertices_point_est)
    var = _np(directional_variance)
    fig, axes = plt.subplots(1, 3, figsize=(12, 4))
    for d, name in enumerate("xyz"):
        sc = axes[d].scatter(verts[:, 0], -verts[:, 1], c=var[:, d], s=1, cmap="jet")
        axes[d].set_title(f"{name} std")
        axes[d].set_aspect("equal")
        fig.colorbar(sc, ax=axes[d])
    if save_path is not None:
        fig.savefig(save_path, dpi=100, bbox_inches="tight")
        plt.close(fig)
        return None
    return fig
