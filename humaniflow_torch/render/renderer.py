"""DensePose UV tables and the silhouette path of the textured IUV renderer.

The counterpart of `humaniflow_tpu/render/renderer.py`, cut down to what
evaluation needs: `load_densepose_uv_host` (the port's own copy of
`_densepose_uv_host`) and `TexturedIUVRenderer` with its orthographic
silhouette renders.  IUV, RGB and depth renders, and the perspective
camera, wait for the training slice.
"""

from dataclasses import dataclass
from functools import lru_cache
from typing import Optional

import numpy as np
import torch

from ..configs import paths
from ..utils.device import resolve_device
from .cuda_coverage import coverage
from .rasterizer import project_orthographic_screen, rasterize_coverage


def load_densepose_uv_host(mat_path: Optional[str] = None) -> dict:
    """DensePose UV data as numpy arrays, read once per process: faces
    (13774, 3) into 7829 DensePose vertices, vertex_map (7829,) into the
    6890 SMPL vertices, per-face part ids, u/v and SURREAL atlas u/v."""
    return dict(_densepose_uv_host(mat_path or paths.DENSEPOSE_UV))


@lru_cache(maxsize=4)
def _densepose_uv_host(mat_path: str):
    from scipy.io import loadmat

    m = loadmat(mat_path)
    faces = np.asarray(m["All_Faces"], np.int64) - 1
    vertex_map = np.asarray(m["All_vertices"], np.int64)[0] - 1
    face_part = np.asarray(m["All_FaceIndices"], np.int64)[:, 0]
    u = np.asarray(m["All_U_norm"], np.float64)[:, 0]
    v = np.asarray(m["All_V_norm"], np.float64)[:, 0]

    # Per-vertex part index from any face containing the vertex.
    vert_part = np.zeros(7829, np.int64)
    vert_part[faces.reshape(-1)] = np.repeat(face_part, 3)

    # SURREAL texture atlas: 4 columns × 6 rows of per-part tiles.
    col = (vert_part - 1) % 4
    row = (vert_part - 1) // 4
    atlas_u = (col + u) / 4.0
    atlas_v = (row + (1.0 - v)) / 6.0

    return {
        "faces": np.asarray(faces, np.int32),
        "vertex_map": np.asarray(vertex_map, np.int32),
        "face_part": np.asarray(face_part, np.int32),
        "u": np.asarray(u, np.float32),
        "v": np.asarray(v, np.float32),
        "atlas_u": np.asarray(atlas_u, np.float32),
        "atlas_v": np.asarray(atlas_v, np.float32),
        "face_atlas_u": np.asarray(atlas_u[faces].mean(1), np.float32),
        "face_atlas_v": np.asarray(atlas_v[faces].mean(1), np.float32),
    }


@dataclass
class TexturedIUVRenderer:
    """Silhouette renderer over SMPL meshes (orthographic camera).

    :param render_rgb: accepted for the JAX renderer's signature; the
        silhouette path renders no RGB.
    :param chunk: faces per chunk of the exact coverage scan.
    :param silhouette_exact: route `render_silhouette_with_overflow`
        through the exact scan (`rasterizer.rasterize_coverage`) on CUDA
        too, instead of kernel K3 with back-face culling.
    :param device: default CUDA; raises if CUDA is unavailable.
    """

    img_wh: int = 256
    projection_type: str = "orthographic"
    render_rgb: bool = True
    uv_mat_path: Optional[str] = None
    chunk: int = 2048
    silhouette_exact: bool = False
    device: Optional[torch.device] = None

    def __post_init__(self):
        if self.projection_type != "orthographic":
            raise NotImplementedError(
                f"projection_type={self.projection_type!r}: the port renders orthographic silhouettes only"
            )
        self.device = resolve_device(self.device)
        host = load_densepose_uv_host(self.uv_mat_path)
        self.dp = {
            "faces": torch.as_tensor(host["faces"], device=self.device).contiguous(),
            "vertex_map": torch.as_tensor(host["vertex_map"], dtype=torch.long, device=self.device),
        }

    def _screen_verts(self, vertices, cam_t, orthographic_scale):
        """(B, V, 3) vertices → screen coordinates under the weak-perspective
        camera (orthographic_scale[:, 0], cam_t[:, 0], cam_t[:, 1]);
        cam_t[:, 2] shifts depth only."""
        cam_wp = torch.stack([orthographic_scale[:, 0], cam_t[:, 0], cam_t[:, 1]], dim=-1)
        verts = vertices + torch.cat([torch.zeros_like(cam_t[:, :2]), cam_t[:, 2:3]], dim=-1)[:, None, :]
        return project_orthographic_screen(verts, cam_wp, self.img_wh)

    def _sil_screen(self, vertices, cam_wp):
        """DensePose-vertex screen coordinates (B, 7829, 3) for the
        weak-perspective camera cam_wp (B, 3) = (scale, tx, ty), depth
        offset 2.5."""
        cam_t = torch.stack([cam_wp[:, 1], cam_wp[:, 2], torch.full_like(cam_wp[:, 0], 2.5)], dim=-1)
        scale = cam_wp[:, [0, 0]]
        dp_verts = vertices[:, self.dp["vertex_map"]]
        return self._screen_verts(dp_verts, cam_t, scale)

    def render_silhouette(self, vertices, cam_wp):
        """Silhouettes (B, wh, wh) float32 through the exact coverage scan
        (all faces, no culling)."""
        screen = self._sil_screen(vertices, cam_wp)
        mask = rasterize_coverage(screen, self.dp["faces"], self.img_wh, chunk=self.chunk)
        return mask.to(torch.float32)

    def render_silhouette_with_overflow(self, vertices, cam_wp):
        """Silhouettes plus a per-mesh overflow count.

        On CUDA, unless silhouette_exact, this is kernel K3 with back-face
        culling (cull_sign=1), the JAX package's shipped configuration.  For
        the consistently wound SMPL body the front faces cover the same
        pixels as all faces, except where a pixel is seen only through the
        DensePose seam hole (13,774 faces, 2 short of SMPL's closed 13,776):
        such a pixel keeps only a back face and drops out, a few pixels per
        mesh at most.  K3 has no capacity, so its overflow is 0 for the
        DensePose face table.  On the CPU, or with silhouette_exact, this is
        the exact scan with overflow 0.

        :return: (mask (B, wh, wh) float32, overflow (B,) int32).
        """
        if self.device.type == "cuda" and not self.silhouette_exact:
            mask, overflow = coverage(self._sil_screen(vertices, cam_wp), self.dp["faces"], self.img_wh, cull_sign=1)
            return mask.to(torch.float32), overflow
        mask = self.render_silhouette(vertices, cam_wp)
        return mask, torch.zeros((vertices.shape[0],), dtype=torch.int32, device=mask.device)
