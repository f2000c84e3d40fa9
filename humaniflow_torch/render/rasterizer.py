"""Exact rasterization in plain PyTorch: the counterpart of
`humaniflow_tpu/render/rasterizer.py`.

`rasterize` is the JAX package's exact z-buffer scan (the renderer's path
off the TPU) and `rasterize_coverage` its exact silhouette scan: every pixel
centre is tested against every face, in chunks.  Neither is a kernel's twin
(K3's is `render/cuda_coverage.py::coverage_plain`, K4's
`render/cuda_raster.py::raster_plain`).  Also the orthographic and
perspective screen projections, barycentric attribute interpolation and
face normals.
"""

from typing import NamedTuple

import torch

BIG_DEPTH = 1e9


class Fragments(NamedTuple):
    face_idx: torch.Tensor  # (B, H, W) int32, -1 where no face is hit
    bary: torch.Tensor      # (B, H, W, 3) barycentrics of the hit
    depth: torch.Tensor     # (B, H, W) depth of the hit, BIG_DEPTH where empty

    @property
    def mask(self):
        return self.face_idx >= 0

# Elements of one (meshes, faces, H, W) intermediate; about 8 such float32
# temporaries are alive at once (~1 GB at this size).
CHUNK_ELEMS = 1 << 25


def chunk_sizes(num_meshes: int, num_faces: int, h: int, w: int, face_chunk: int):
    """(meshes per chunk, faces per chunk) keeping one (meshes, faces, H, W)
    intermediate within CHUNK_ELEMS elements."""
    fc = max(1, min(face_chunk, num_faces, CHUNK_ELEMS // (h * w)))
    mc = max(1, min(num_meshes, CHUNK_ELEMS // (fc * h * w)))
    return mc, fc


def _barycentrics(tri: torch.Tensor, gx: torch.Tensor, gy: torch.Tensor):
    """(w0, w1, w2, valid) of the pixel centres (gx, gy) against the faces
    tri (M, F, 3, 3): w0, w1 from the edge functions times 1/area,
    w2 = 1 − w0 − w1, each (M, F, H, W); valid (M, F, 1, 1) is |area| > 1e-9."""
    x0, y0 = tri[..., 0, 0, None, None], tri[..., 0, 1, None, None]
    x1, y1 = tri[..., 1, 0, None, None], tri[..., 1, 1, None, None]
    x2, y2 = tri[..., 2, 0, None, None], tri[..., 2, 1, None, None]
    area = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0)
    valid = torch.abs(area) > 1e-9
    inv = valid.to(torch.float32) / torch.where(valid, area, torch.ones_like(area))
    w0 = ((x2 - x1) * (gy - y1) - (y2 - y1) * (gx - x1)) * inv
    w1 = ((x0 - x2) * (gy - y2) - (y0 - y2) * (gx - x2)) * inv
    return w0, w1, 1.0 - w0 - w1, valid


def rasterize_coverage(verts_screen: torch.Tensor, faces: torch.Tensor, image_size: int,
                       chunk: int = 2048) -> torch.Tensor:
    """Coverage-only rasterization: the per-pixel any-face-covers mask.

    Every pixel centre (col + 0.5, row + 0.5) is tested against every face
    (no culling), in chunks over meshes and faces so that one intermediate
    holds at most CHUNK_ELEMS elements.

    :param verts_screen: (B, V, 3) float32 screen coordinates (x = column,
        y = row, depth).
    :param faces: (F, 3) vertex indices.
    :param chunk: faces per chunk at most.
    :return: (B, H, W) bool coverage mask, H = W = image_size.
    """
    b = verts_screen.shape[0]
    h = w = image_size
    f = faces.shape[0]
    mc, fc = chunk_sizes(b, f, h, w, chunk)
    gx = (torch.arange(w, dtype=torch.float32, device=verts_screen.device) + 0.5)[None, None, None, :]
    gy = (torch.arange(h, dtype=torch.float32, device=verts_screen.device) + 0.5)[None, None, :, None]
    faces = faces.to(device=verts_screen.device, dtype=torch.long)
    out = torch.zeros((b, h, w), dtype=torch.bool, device=verts_screen.device)
    for m0 in range(0, b, mc):
        verts = verts_screen[m0 : m0 + mc]
        mask = out[m0 : m0 + mc]
        for f0 in range(0, f, fc):
            w0, w1, w2, valid = _barycentrics(verts[:, faces[f0 : f0 + fc]], gx, gy)
            inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0) & valid
            mask |= inside.any(dim=1)
    return out


def project_orthographic_screen(verts: torch.Tensor, cam_wp: torch.Tensor, image_size: int) -> torch.Tensor:
    """Weak-perspective camera → screen coordinates, consistent with the 2D
    joint projection (ops/camera.orthographic_project +
    undo_keypoint_normalisation): px = (s·(X + t) + 1)·wh/2, y down.

    :param verts: (B, V, 3), already in the renderer's frame (callers apply
        the x-axis π flip).
    :param cam_wp: (B, 3) — (scale, tx, ty).
    """
    s = cam_wp[:, None, 0:1]
    t = cam_wp[:, None, 1:3]
    xy = (s * (verts[..., :2] + t) + 1.0) * (image_size / 2.0)
    return torch.cat([xy, verts[..., 2:3]], dim=-1)


def zbuffer_scan(verts_screen: torch.Tensor, faces: torch.Tensor, image_size: int, chunk: int = 1024,
                 live_fn=None) -> Fragments:
    """The z-buffer scan behind `rasterize`, in chunks over meshes and faces.

    Per chunk the candidates are the faces whose pixel centre is inside;
    the smallest candidate z wins, the lowest face id on a tie, and replaces
    the running winner only when strictly nearer.  With live_fn(m0, m1, ids)
    → bool (m1 − m0, len(ids), H, W), a candidate must also be live and have
    z < BIG_DEPTH, so a NaN depth never wins; without it a NaN depth makes
    its chunk's minimum NaN, and the chunk loses at that pixel (the JAX scan).
    """
    b = verts_screen.shape[0]
    h = w = image_size
    f = faces.shape[0]
    dev = verts_screen.device
    mc, fc = chunk_sizes(b, f, h, w, chunk)
    gx = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5)[None, None, None, :]
    gy = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5)[None, None, :, None]
    faces = faces.to(device=dev, dtype=torch.long)
    depth = torch.full((b, h, w), BIG_DEPTH, dtype=torch.float32, device=dev)
    face_idx = torch.full((b, h, w), -1, dtype=torch.int32, device=dev)
    bary = torch.zeros((b, h, w, 3), dtype=torch.float32, device=dev)
    for m0 in range(0, b, mc):
        m1 = min(m0 + mc, b)
        for f0 in range(0, f, fc):
            ids = torch.arange(f0, min(f0 + fc, f), device=dev)
            tri = verts_screen[m0:m1][:, faces[ids]]  # (mc, fc, 3, 3)
            w0, w1, w2, valid = _barycentrics(tri, gx, gy)
            z = w0 * tri[..., 0, 2, None, None] + w1 * tri[..., 1, 2, None, None] + w2 * tri[..., 2, 2, None, None]
            inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0) & valid
            if live_fn is not None:
                inside &= live_fn(m0, m1, ids) & (z < BIG_DEPTH)
            z = torch.where(inside, z, BIG_DEPTH)
            zmin = z.amin(dim=1)  # (mc, H, W)
            first = ((z <= zmin[:, None]) & inside).to(torch.uint8).argmax(dim=1, keepdim=True)  # lowest id
            take = zmin < depth[m0:m1]
            pick = lambda t: torch.take_along_dim(t, first, dim=1)[:, 0]  # noqa: E731
            cand_bary = torch.stack([pick(w0), pick(w1), pick(w2)], dim=-1)
            depth[m0:m1] = torch.where(take, zmin, depth[m0:m1])
            face_idx[m0:m1] = torch.where(take, (first[:, 0] + f0).to(torch.int32), face_idx[m0:m1])
            bary[m0:m1] = torch.where(take[..., None], cand_bary, bary[m0:m1])
    return Fragments(face_idx=face_idx, bary=bary, depth=depth)


def rasterize(verts_screen: torch.Tensor, faces: torch.Tensor, image_size: int, chunk: int = 1024) -> Fragments:
    """Exact z-buffered rasterization of meshes already in screen space.

    Barycentrics are the JAX scan's: w0, w1 from the edge functions times
    1/area, w2 = 1 − w0 − w1; a pixel centre is inside when all three are
    ≥ 0 (either winding).  z = Σ wᵢ·zᵢ; the smallest z below BIG_DEPTH wins,
    ties going to the lowest face id.

    :param verts_screen: (B, V, 3) — (x_px, y_px, depth); x = column, y = row.
    :param faces: (F, 3) vertex indices.
    :param chunk: faces per chunk at most.
    """
    return zbuffer_scan(verts_screen, faces, image_size, chunk)


def project_perspective_screen(verts: torch.Tensor, cam_t: torch.Tensor, focal_length: float,
                               image_size: int) -> torch.Tensor:
    """Pinhole camera at translation cam_t, principal point at the image
    centre: (B, V, 3) → (x_px, y_px, camera-space z)."""
    v = verts + cam_t[:, None, :]
    z = torch.clamp(v[..., 2:3], min=1e-6)
    xy = v[..., :2] / z * focal_length + image_size / 2.0
    return torch.cat([xy, v[..., 2:3]], dim=-1)


def interpolate_face_attributes(fragments: Fragments, faces: torch.Tensor, vert_attrs: torch.Tensor) -> torch.Tensor:
    """Barycentric interpolation of per-vertex attributes at the hit pixels.

    :param vert_attrs: (B, V, D) or shared (V, D).
    :return: (B, H, W, D), zeros where no face.
    """
    fidx = torch.clamp(fragments.face_idx, min=0).long()
    tri = faces.long()[fidx]  # (B, H, W, 3)
    if vert_attrs.dim() == 2:
        attr = vert_attrs[tri]
    else:
        attr = vert_attrs[torch.arange(tri.shape[0], device=tri.device)[:, None, None, None], tri]
    out = torch.einsum("...k,...kd->...d", fragments.bary, attr)
    return torch.where(fragments.mask[..., None], out, 0.0)


def face_normals(verts: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    """(B, F, 3) unit face normals."""
    tri = verts[:, faces.long()]  # (B, F, 3, 3)
    n = torch.linalg.cross(tri[:, :, 1] - tri[:, :, 0], tri[:, :, 2] - tri[:, :, 0], dim=-1)
    return n / torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True), min=1e-12)
