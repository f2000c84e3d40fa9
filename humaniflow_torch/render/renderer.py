"""Textured IUV renderer over SMPL meshes: silhouettes, IUV, depth and
Lambert-lit RGB.

The counterpart of `humaniflow_tpu/render/renderer.py`: the DensePose UV
tables (`load_densepose_uv_host`, the port's own copy of
`_densepose_uv_host`, and `load_densepose_uv`, the same on a device) and `TexturedIUVRenderer` with the orthographic and
perspective cameras, the exact render (`_render`, through the exact scan or
the tile-culled kernel K6 on CUDA), the attribute-rasterizer render
(`_render_binned_fused`, kernel K4 on CUDA) and the silhouette path (kernel
K3 on CUDA).
"""

from dataclasses import dataclass
from functools import lru_cache
from typing import Dict, Optional

import numpy as np
import torch

from ..configs import paths
from ..utils.device import resolve_device
from .cuda_coverage import coverage
from .cuda_raster import rasterize_with_attrs
from .cuda_tiled import rasterize_tiled, tile_sort_order
from .rasterizer import (
    face_normals,
    project_orthographic_screen,
    project_perspective_screen,
    rasterize,
    rasterize_coverage,
)


def load_densepose_uv_host(mat_path: Optional[str] = None) -> dict:
    """DensePose UV data as numpy arrays, read once per process: faces
    (13774, 3) into 7829 DensePose vertices, vertex_map (7829,) into the
    6890 SMPL vertices, per-face part ids, u/v and SURREAL atlas u/v."""
    return dict(_densepose_uv_host(mat_path or paths.DENSEPOSE_UV))


def load_densepose_uv(mat_path: Optional[str] = None, device=None) -> dict:
    """load_densepose_uv_host's arrays as tensors on `device` (default CUDA;
    raises if it is unavailable), with the host arrays' dtypes."""
    device = resolve_device(device)
    return {k: torch.as_tensor(v, device=device) for k, v in _densepose_uv_host(mat_path or paths.DENSEPOSE_UV).items()}


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


DEFAULT_LIGHTS = {
    "location": ((0.0, -0.8, -2.0),),
    "ambient_color": ((0.5, 0.5, 0.5),),
    "diffuse_color": ((0.3, 0.3, 0.3),),
    "specular_color": ((0.0, 0.0, 0.0),),
}


def _lights(settings: Optional[Dict], device) -> Dict[str, torch.Tensor]:
    """DEFAULT_LIGHTS updated by `settings`, as (B|1, 3) float32 tensors."""
    lights = {k: torch.tensor(v, dtype=torch.float32, device=device) for k, v in DEFAULT_LIGHTS.items()}
    for k, v in (settings or {}).items():
        lights[k] = torch.as_tensor(v, dtype=torch.float32, device=device)
    return lights


def _unit(v: torch.Tensor, eps: float) -> torch.Tensor:
    return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=eps)


def _texels(textures: torch.Tensor, u: torch.Tensor, v: torch.Tensor, shared: bool = False) -> torch.Tensor:
    """Nearest texels of textures (B, TH, TW, 3) at atlas coordinates u, v
    in [0, 1]: (B, ...) → (B, ..., 3), or with shared, one table (...) for
    the whole batch."""
    b, th, tw = textures.shape[:3]
    tx = torch.round(torch.clamp(u * (tw - 1), 0, tw - 1)).long()
    ty = torch.round(torch.clamp(v * (th - 1), 0, th - 1)).long()
    idx = ty * tw + tx
    if shared:
        idx = idx.expand((b,) + idx.shape)
    flat = idx.reshape(b, -1, 1).expand(-1, -1, 3)
    return torch.gather(textures.reshape(b, th * tw, 3), 1, flat).reshape(idx.shape + (3,))


@dataclass
class TexturedIUVRenderer:
    """Renderer over SMPL meshes (meshes already flipped by the x-axis π
    rotation, as the reference does before rendering).

    :param projection_type: "orthographic" (evaluation, visualisation) or
        "perspective" (training data, focal_length at the image centre).
    :param chunk: faces per chunk of the exact scans.
    :param rasterizer: "xla" renders through the exact scan
        (render/rasterizer.py::rasterize), as the JAX package does off the
        TPU; "binned" through the attribute rasterizer (`_render_binned_fused`:
        kernel K4 on CUDA when img_wh % 128 == 0, the exact scan otherwise,
        as the JAX package routes it); "tiled" through the tile-culled
        rasterizer (`render/cuda_tiled.py`: kernel K6 on CUDA when
        img_wh % 128 == 0, the exact scan otherwise), with the faces sorted
        by the screen tile of mesh 0's centroids.
    :param texture_sampling: for the attribute rasterizer, "pixel" (one atlas
        lookup per pixel), "vertex" (one texel per DensePose vertex,
        interpolated) or "face" (one texel per face centroid, lit per face:
        the kernel writes finished RGB).
    :param emit_uv: for the attribute rasterizer, False skips the UV planes
        (U = V = 0) for consumers of the part channel alone.
    :param binned_cull: back-face culling (cull_sign 1) in the attribute
        rasterizer.  The JAX renderer's binning capacities (binned_k_max,
        binned_live_cap, ...) have no counterpart: K4 has no capacity.
    :param emit_overflow: add "binning_overflow", the faces the rasterizer
        dropped (K4: only faces with an out-of-range vertex index), to the
        render output.
    :param silhouette_exact: route `render_silhouette_with_overflow`
        through the exact scan (`rasterizer.rasterize_coverage`) on CUDA
        too, instead of kernel K3 with back-face culling.
    :param device: default CUDA; raises if CUDA is unavailable.
    """

    img_wh: int = 256
    projection_type: str = "orthographic"
    focal_length: float = 300.0
    render_rgb: bool = True
    uv_mat_path: Optional[str] = None
    chunk: int = 2048
    rasterizer: str = "xla"
    texture_sampling: str = "pixel"
    emit_uv: bool = True
    binned_cull: bool = False
    emit_overflow: bool = False
    silhouette_exact: bool = False
    device: Optional[torch.device] = None

    def __post_init__(self):
        if self.projection_type not in ("orthographic", "perspective"):
            raise ValueError(f"projection_type must be orthographic or perspective, got {self.projection_type!r}")
        if self.rasterizer not in ("xla", "tiled", "binned"):
            raise ValueError(f"rasterizer must be xla, tiled or binned, got {self.rasterizer!r}")
        if self.texture_sampling not in ("pixel", "vertex", "face"):
            raise ValueError(f"texture_sampling must be pixel, vertex or face, got {self.texture_sampling!r}")
        self.device = resolve_device(self.device)
        # JAX routing (renderer.py:216-219): the kernels run on the
        # accelerator at img_wh % 128 == 0, the exact scan everywhere else
        if self.rasterizer != "xla" and (self.device.type == "cpu" or self.img_wh % 128 != 0):
            self.rasterizer = "xla"
        host = load_densepose_uv_host(self.uv_mat_path)
        dev = self.device
        self.dp = {
            "faces": torch.as_tensor(host["faces"], device=dev).contiguous(),
            "vertex_map": torch.as_tensor(host["vertex_map"], dtype=torch.long, device=dev),
            "face_part": torch.as_tensor(host["face_part"], device=dev),
        }
        for k in ("u", "v", "atlas_u", "atlas_v", "face_atlas_u", "face_atlas_v"):
            self.dp[k] = torch.as_tensor(host[k], device=dev)

    def _rasterize(self, screen):
        """(fragments, faces, face_part) of the exact backends.  "tiled"
        reorders the faces by the tile of mesh 0's centroids (a stable sort,
        as jnp.argsort is) and returns them in that order, which every later
        lookup uses; face_idx indexes the returned faces."""
        faces, face_part = self.dp["faces"], self.dp["face_part"]
        if self.rasterizer == "xla":
            return rasterize(screen, faces, self.img_wh, chunk=self.chunk), faces, face_part
        order = tile_sort_order(screen[0], faces)
        faces, face_part = faces[order].contiguous(), face_part[order]
        return rasterize_tiled(screen, faces, self.img_wh), faces, face_part

    def _screen_verts(self, vertices, cam_t=None, orthographic_scale=None):
        """(B, V, 3) vertices → screen coordinates.  Orthographic: the
        weak-perspective camera (orthographic_scale[:, 0] (default 0.9),
        cam_t[:, 0], cam_t[:, 1]); cam_t[:, 2] shifts depth only.
        Perspective: the pinhole camera at cam_t."""
        if self.projection_type == "perspective":
            return project_perspective_screen(vertices, cam_t, self.focal_length, self.img_wh)
        b = vertices.shape[0]
        scale = (orthographic_scale[:, 0] if orthographic_scale is not None
                 else torch.full((b,), 0.9, dtype=vertices.dtype, device=vertices.device))
        t = cam_t if cam_t is not None else vertices.new_zeros((b, 3))
        cam_wp = torch.stack([scale, t[:, 0], t[:, 1]], dim=-1)
        verts = vertices + torch.cat([torch.zeros_like(t[:, :2]), t[:, 2:3]], dim=-1)[:, None, :]
        return project_orthographic_screen(verts, cam_wp, self.img_wh)

    def __call__(self, vertices, cam_t=None, orthographic_scale=None, textures=None, lights_rgb_settings=None,
                 verts_features=None) -> Dict[str, torch.Tensor]:
        """Render IUV (+ RGB, depth) images.

        :param vertices: (B, 6890, 3) SMPL vertices (pre-flipped).
        :param textures: (B, 1200, 800, 3) SURREAL texture atlases for
            textured RGB; verts_features: (B, 6890, 3) or (6890, 3)
            per-vertex colours instead.
        :return: iuv_images (B, wh, wh, 3) [part, U, V], depth_images
            (B, wh, wh), silhouettes (B, wh, wh), rgb_images when asked for
            (and binning_overflow with emit_overflow).
        """
        return self._render(vertices, cam_t, orthographic_scale, textures, lights_rgb_settings, verts_features)

    def _render(self, vertices, cam_t=None, orthographic_scale=None, textures=None, lights_rgb_settings=None,
                verts_features=None):
        dp_verts = vertices[:, self.dp["vertex_map"]]  # (B, 7829, 3)
        screen = self._screen_verts(dp_verts, cam_t, orthographic_scale)
        want_rgb = self.render_rgb and (textures is not None or verts_features is not None)
        if self.rasterizer == "binned":
            return self._render_binned_fused(screen, dp_verts, cam_t, orthographic_scale, textures,
                                             lights_rgb_settings, verts_features, want_rgb)
        frags, faces, face_part = self._rasterize(screen)
        faces = faces.long()
        mask = frags.mask
        fidx = torch.clamp(frags.face_idx, min=0).long()  # (B, H, W)

        static = [torch.stack([self.dp["u"], self.dp["v"]], dim=-1)]
        if want_rgb and textures is not None:
            static.append(torch.stack([self.dp["atlas_u"], self.dp["atlas_v"]], dim=-1))
        tri_static = torch.cat(static, dim=-1)[faces]  # (F, 3, Ds)
        static_px = torch.where(
            mask[..., None], torch.einsum("...k,...kd->...d", frags.bary, tri_static[fidx]), 0.0
        )
        part = torch.where(mask, face_part[fidx], 0).to(torch.float32)
        out = {
            "iuv_images": torch.cat([part[..., None], static_px[..., :2]], dim=-1),
            "depth_images": torch.where(mask, frags.depth, 0.0),
            "silhouettes": mask.to(torch.float32),
        }
        if self.emit_overflow:
            out["binning_overflow"] = torch.zeros((), dtype=torch.int32, device=vertices.device)
        if not want_rgb:
            return out

        b = vertices.shape[0]
        bi = torch.arange(b, device=vertices.device)[:, None, None]
        tri_pos = dp_verts[:, faces]  # (B, F, 3, 3)
        pix_normal = torch.where(mask[..., None], face_normals(dp_verts, faces)[bi, fidx], 0.0)
        pix_pos = torch.where(mask[..., None], torch.einsum("...k,...kd->...d", frags.bary, tri_pos[bi, fidx]), 0.0)
        if textures is not None:
            albedo = _texels(textures, static_px[..., 2], static_px[..., 3])
        else:
            vf = verts_features[:, self.dp["vertex_map"]] if verts_features.dim() == 3 else (
                verts_features[self.dp["vertex_map"]].expand(dp_verts.shape))
            albedo = torch.where(mask[..., None], torch.einsum("...k,...kd->...d", frags.bary, vf[:, faces][bi, fidx]),
                                 0.0)
        lights = _lights(lights_rgb_settings, vertices.device)
        light_dir = _unit(lights["location"][:, None, None, :] - pix_pos, 1e-8)
        lambert = torch.abs(torch.sum(pix_normal * light_dir, dim=-1, keepdim=True))
        rgb = torch.clamp(albedo * (lights["ambient_color"][:, None, None, :]
                                    + lights["diffuse_color"][:, None, None, :] * lambert), 0.0, 1.0)
        out["rgb_images"] = torch.where(mask[..., None], rgb, 0.0)
        return out

    def _render_binned_fused(self, screen, dp_verts, cam_t, orthographic_scale, textures, lights_rgb_settings,
                             verts_features, want_rgb):
        """Render through the attribute rasterizer (K4 on CUDA): UV, part id
        and albedo source are interpolated in the rasterizer, and positions
        and normals reconstructed from (x, y, depth, za, zb), with no
        per-pixel gather but the "pixel" mode's texture lookup.  With
        texture_sampling="face" the constant attribute is one texel per face
        centroid pre-lit by flat per-face Lambert, so the rasterizer writes
        finished RGB."""
        b = screen.shape[0]
        faces = self.dp["faces"].long()
        wh = float(self.img_wh)
        lights = _lights(lights_rgb_settings, screen.device)
        face_tex = want_rgb and textures is not None and self.texture_sampling == "face"
        per_pixel_tex = want_rgb and textures is not None and self.texture_sampling == "pixel"
        emit_uv = self.emit_uv or per_pixel_tex  # pixel mode needs the atlas UV

        # atlas UV is interpolated and (u, v) recovered from it per pixel:
        # within a face atlas_u = (col(part) + u)/4 and atlas_v =
        # (row(part) + 1 − v)/6 are linear in (u, v)
        lin_parts = []
        if emit_uv:
            lin_parts.append(torch.stack([self.dp["atlas_u"], self.dp["atlas_v"]], dim=-1)[faces][None])
        const_parts = []
        if want_rgb and not per_pixel_tex:
            if face_tex:
                texel_f = _texels(textures, self.dp["face_atlas_u"], self.dp["face_atlas_v"], shared=True)
                tri_w = dp_verts[:, faces]  # (B, F, 3, 3)
                n = _unit(torch.linalg.cross(tri_w[:, :, 1] - tri_w[:, :, 0], tri_w[:, :, 2] - tri_w[:, :, 0],
                                             dim=-1), 1e-12)
                ldir = _unit(lights["location"][:, None, :] - tri_w.mean(dim=2), 1e-8)
                lam = torch.abs(torch.sum(n * ldir, dim=-1, keepdim=True))
                const_parts.append(texel_f * (lights["ambient_color"][:, None, :]
                                              + lights["diffuse_color"][:, None, :] * lam))
            elif textures is not None:
                lin_parts.append(_texels(textures, self.dp["atlas_u"], self.dp["atlas_v"], shared=True)[:, faces])
            else:
                vf = verts_features[:, self.dp["vertex_map"]] if verts_features.dim() == 3 else (
                    verts_features[self.dp["vertex_map"]][None])
                lin_parts.append(vf[:, faces])
        lin = None
        if lin_parts:
            lead = max(p.shape[0] for p in lin_parts)
            lin = torch.cat([p.expand((lead,) + p.shape[1:]) for p in lin_parts], dim=-1)
        const_parts.append(self.dp["face_part"].to(torch.float32)[None, :, None])
        lead = max(p.shape[0] for p in const_parts)
        const = torch.cat([p.expand(lead, faces.shape[0], p.shape[-1]) for p in const_parts], dim=-1)
        z_grads = want_rgb and not face_tex

        frags, planes, overflow, _ = rasterize_with_attrs(
            screen, self.dp["faces"], self.img_wh, lin_attrs=lin, const_attrs=const, z_grads=z_grads,
            emit_frags=False, cull_sign=1 if self.binned_cull else 0,
        )
        mask = frags.mask
        # plane layout: [atlas uv?][lin albedo?][lit rgb?][part][za zb?]
        i = 0
        if emit_uv:
            atlas_uv, i = planes[..., 0:2], 2
        if want_rgb and not per_pixel_tex:
            albedo, i = planes[..., i:i + 3], i + 3
        part, i = planes[..., i], i + 1
        if emit_uv:
            pm1 = torch.clamp(part - 1.0, min=0.0)
            tile_row = torch.floor(pm1 / 4.0)
            tile_col = pm1 - 4.0 * tile_row
            u_px = torch.where(mask, 4.0 * atlas_uv[..., 0] - tile_col, 0.0)
            v_px = torch.where(mask, 1.0 - (6.0 * atlas_uv[..., 1] - tile_row), 0.0)
        else:
            u_px = v_px = torch.zeros_like(part)
        out = {
            "iuv_images": torch.stack([part, u_px, v_px], dim=-1),
            "depth_images": torch.where(mask, frags.depth, 0.0),
            "silhouettes": mask.to(torch.float32),
        }
        if self.emit_overflow:
            out["binning_overflow"] = overflow.sum().to(torch.int32)
        if not want_rgb:
            return out
        if face_tex:
            # lit per face already; the clip is exact as the light is constant per face
            out["rgb_images"] = torch.where(mask[..., None], torch.clamp(albedo, 0.0, 1.0), 0.0)
            return out

        za, zb = planes[..., i], planes[..., i + 1]
        if per_pixel_tex:
            albedo = _texels(textures, atlas_uv[..., 0], atlas_uv[..., 1])
        dev = screen.device
        gx = (torch.arange(self.img_wh, dtype=torch.float32, device=dev) + 0.5)[None, None, :]
        gy = (torch.arange(self.img_wh, dtype=torch.float32, device=dev) + 0.5)[None, :, None]
        z = frags.depth
        if self.projection_type == "perspective":
            c, fl = wh / 2.0, self.focal_length
            xc, yc = gx - c, gy - c
            pix_pos = torch.stack([xc * z / fl, yc * z / fl, z], dim=-1) - cam_t[:, None, None, :]
            ddx = torch.stack([(z + xc * za) / fl, (yc * za / fl).expand(z.shape), za], dim=-1)
            ddy = torch.stack([(xc * zb / fl).expand(z.shape), (z + yc * zb) / fl, zb], dim=-1)
        else:
            s = (orthographic_scale[:, 0] if orthographic_scale is not None
                 else torch.full((b,), 0.9, dtype=torch.float32, device=dev))[:, None, None]
            t = (cam_t if cam_t is not None else torch.zeros((b, 3), dtype=torch.float32, device=dev))[:, None, None, :]
            x_w = (2.0 * gx / wh - 1.0) / s - t[..., 0]
            y_w = (2.0 * gy / wh - 1.0) / s - t[..., 1]
            k = (2.0 / (wh * s)).expand(z.shape)
            zero = torch.zeros_like(z)
            pix_pos = torch.stack([x_w.expand(z.shape), y_w.expand(z.shape), z - t[..., 2]], dim=-1)
            ddx = torch.stack([k, zero, za], dim=-1)
            ddy = torch.stack([zero, k, zb], dim=-1)
        normal = _unit(torch.linalg.cross(ddx, ddy, dim=-1), 1e-12)
        light_dir = _unit(lights["location"][:, None, None, :] - pix_pos, 1e-8)
        lambert = torch.abs(torch.sum(normal * light_dir, dim=-1, keepdim=True))
        rgb = torch.clamp(albedo * (lights["ambient_color"][:, None, None, :]
                                    + lights["diffuse_color"][:, None, None, :] * lambert), 0.0, 1.0)
        out["rgb_images"] = torch.where(mask[..., None], rgb, 0.0)
        return out

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
