"""Exact coverage rasterization and the orthographic screen projection: the
parts of `humaniflow_tpu/render/rasterizer.py` that silhouettes need.

`rasterize_coverage` is the JAX package's exact silhouette path (a
per-pixel scan of every face), in plain PyTorch; it is not kernel K3's twin
(that is `render/cuda_coverage.py::coverage_plain`).  The z-buffered
`rasterize`, attribute interpolation and face normals wait for the training
slice.
"""

import torch

# Elements of one (meshes, faces, H, W) intermediate; about 8 such float32
# temporaries are alive at once (~1 GB at this size).
CHUNK_ELEMS = 1 << 25


def chunk_sizes(num_meshes: int, num_faces: int, h: int, w: int, face_chunk: int):
    """(meshes per chunk, faces per chunk) keeping one (meshes, faces, H, W)
    intermediate within CHUNK_ELEMS elements."""
    fc = max(1, min(face_chunk, num_faces, CHUNK_ELEMS // (h * w)))
    mc = max(1, min(num_meshes, CHUNK_ELEMS // (fc * h * w)))
    return mc, fc


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
            tri = verts[:, faces[f0 : f0 + fc]]  # (mc, fc, 3, 3)
            x0, y0 = tri[..., 0, 0, None, None], tri[..., 0, 1, None, None]
            x1, y1 = tri[..., 1, 0, None, None], tri[..., 1, 1, None, None]
            x2, y2 = tri[..., 2, 0, None, None], tri[..., 2, 1, None, None]
            area = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0)
            valid = torch.abs(area) > 1e-9
            inv = valid.to(torch.float32) / torch.where(valid, area, torch.ones_like(area))
            w0 = ((x2 - x1) * (gy - y1) - (y2 - y1) * (gx - x1)) * inv
            w1 = ((x0 - x2) * (gy - y2) - (y0 - y2) * (gx - x2)) * inv
            w2 = 1.0 - w0 - w1
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
