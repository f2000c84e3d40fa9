"""Silhouette coverage kernel K3 (csrc/coverage.cu) and its plain twin.

The counterpart of the coverage path of
`humaniflow_tpu/render/binned_rasterizer.py` (`rasterize_binned_coverage`
with its kernels `_make_coverage_table_kernel` and `_make_coverage_kernel`),
plus the port's `_edge_plane_coeffs`.

Contract (both functions): a pixel of mesh m is covered when some kept face
has min(w0, w1, w2) ≥ 0 at the pixel centre (col + 0.5, row + 0.5) and the
pixel lies in the face's bounding box widened by one pixel, with
w0 = a0·x + b0·y + c0, w1 = a1·x + b1·y + c1, w2 = 1 − w0 − w1 from the
edge-plane coefficients.  A face is kept when its six screen coordinates
are finite, |signed area| > 1e-9, and signed area · cull_sign > 0 unless
cull_sign is 0.  The box rule only removes pixels that the rounding of a
nearly degenerate face would claim far from the face itself.

The TPU kernel binned faces into strips of fixed capacity and reported the
candidates it dropped as `overflow`.  K3 has no capacity: `overflow` (M,)
counts only faces whose vertex indices lie outside [0, V), which are
dropped, and is 0 for any valid face table.

K3 gives each (mesh, band of rows) one block, which keeps the band's mask
as bits in shared memory and skips the faces and pixels already covered;
`band_plan` cuts the image into bands whose bits fit `BAND_WORDS` (the
whole image up to 512²).  csrc/coverage.cu describes the design.

`coverage` computes the twin when the tensors lie on the CPU.  For CUDA
tensors it launches K3, or raises on a wrong dtype, device, layout or
shape; it never falls back.  K3 has no backward: on CUDA `coverage` raises
when grad mode is on and verts_screen requires grad.  `LAUNCHES` counts its
kernel launches, which the spans of utils/tracing.py read.
"""

import ctypes

import torch

from ..utils.cuda_build import load_library, refuse_grad
from ..utils.tracing import launch_counter
from .rasterizer import chunk_sizes

LAUNCHES = launch_counter({"coverage": 0})
BAND_WORDS = 8192  # csrc/coverage.cu kBandWords: 32 KB of mask bits per block


def band_plan(image_size: int):
    """(rows per band, number of bands) of K3 at this image size: the
    largest band whose bits, ceil(W / 32) words a row, fit BAND_WORDS."""
    words_per_row = -(-image_size // 32)
    rows = min(image_size, BAND_WORDS // words_per_row)
    return rows, -(-image_size // rows)


def _edge_plane_coeffs(tri: torch.Tensor) -> torch.Tensor:
    """(…, 9) packed screen coordinates [x0 y0 z0 x1 y1 z1 x2 y2 z2] →
    (…, 9) coefficients [a0 b0 c0 a1 b1 c1 za zb zc]; a degenerate face
    (|area| ≤ 1e-9) gets c0 = −1, so it is never inside."""
    x0, y0, z0 = tri[..., 0], tri[..., 1], tri[..., 2]
    x1, y1, z1 = tri[..., 3], tri[..., 4], tri[..., 5]
    x2, y2, z2 = tri[..., 6], tri[..., 7], tri[..., 8]
    area = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0)
    valid = torch.abs(area) > 1e-9
    inv = valid.to(area.dtype) / torch.where(valid, area, torch.ones_like(area))
    a0 = -(y2 - y1) * inv
    b0 = (x2 - x1) * inv
    c0 = ((y2 - y1) * x1 - (x2 - x1) * y1) * inv
    a1 = -(y0 - y2) * inv
    b1 = (x0 - x2) * inv
    c1 = ((y0 - y2) * x2 - (x0 - x2) * y2) * inv
    za = a0 * (z0 - z2) + a1 * (z1 - z2)
    zb = b0 * (z0 - z2) + b1 * (z1 - z2)
    zc = c0 * (z0 - z2) + c1 * (z1 - z2) + z2
    c0 = torch.where(valid, c0, torch.full_like(c0, -1.0))
    return torch.stack([a0, b0, c0, a1, b1, c1, za, zb, zc], dim=-1)


def coverage_plain(verts_screen: torch.Tensor, faces: torch.Tensor, image_size: int, cull_sign: int = 0):
    """Plain PyTorch twin of K3: tests every pixel against every face, in
    chunks over meshes and faces, with K3's operation order.

    :param verts_screen: (M, V, 3) float32 screen coordinates.
    :param faces: (F, 3) vertex indices.
    :return: (mask (M, H, W) bool, overflow (M,) int32), H = W = image_size.
    """
    m, v = verts_screen.shape[:2]
    h = w = image_size
    f = faces.shape[0]
    dev = verts_screen.device
    faces = faces.to(device=dev, dtype=torch.long)
    index_ok = ((faces >= 0) & (faces < v)).all(dim=-1)  # (F,)
    faces = torch.where(index_ok[:, None], faces, torch.zeros_like(faces))
    mc, fc = chunk_sizes(m, f, h, w, face_chunk=1024)
    cols = torch.arange(w, dtype=torch.float32, device=dev)[None, None, None, :]
    rows = torch.arange(h, dtype=torch.float32, device=dev)[None, None, :, None]
    gx, gy = cols + 0.5, rows + 0.5
    mask = torch.zeros((m, h, w), dtype=torch.bool, device=dev)
    for m0 in range(0, m, mc):
        verts = verts_screen[m0 : m0 + mc]
        out = mask[m0 : m0 + mc]
        for f0 in range(0, f, fc):
            tri = verts[:, faces[f0 : f0 + fc]]  # (mc, fc, 3, 3)
            coef = _edge_plane_coeffs(tri.reshape(tri.shape[:2] + (9,)))
            x, y = tri[..., 0], tri[..., 1]  # (mc, fc, 3)
            x0, y0, x1, y1, x2, y2 = x[..., 0], y[..., 0], x[..., 1], y[..., 1], x[..., 2], y[..., 2]
            area = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0)
            keep = torch.isfinite(tri[..., :2]).all(dim=-1).all(dim=-1) & (torch.abs(area) > 1e-9)
            keep &= index_ok[f0 : f0 + fc]
            if cull_sign != 0:
                keep &= (area * float(cull_sign)) > 0
            in_x = (cols >= (torch.floor(x.amin(-1)) - 1.0)[..., None, None]) & (
                cols <= (torch.ceil(x.amax(-1)) + 1.0)[..., None, None]
            )
            in_y = (rows >= (torch.floor(y.amin(-1)) - 1.0)[..., None, None]) & (
                rows <= (torch.ceil(y.amax(-1)) + 1.0)[..., None, None]
            )
            c = coef[..., :6, None, None]
            w0 = (c[:, :, 0] * gx + c[:, :, 1] * gy) + c[:, :, 2]
            w1 = (c[:, :, 3] * gx + c[:, :, 4] * gy) + c[:, :, 5]
            w2 = (1.0 - w0) - w1
            inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0) & in_x & in_y & keep[..., None, None]
            out |= inside.any(dim=1)
    overflow = (~index_ok).sum().to(torch.int32).expand(m).contiguous().to(dev)
    return mask, overflow


def _check(verts_screen: torch.Tensor, faces: torch.Tensor, image_size: int, cull_sign: int):
    """Raise unless K3 can take these arguments."""
    dev = verts_screen.device
    for name, t, dtype in (("verts_screen", verts_screen, torch.float32), ("faces", faces, torch.int32)):
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor on {dev}, got {t.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.dim() != (3 if name == "verts_screen" else 2) or t.shape[-1] != 3:
            raise ValueError(f"{name} has shape {tuple(t.shape)}; expected (M, V, 3) / (F, 3)")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if verts_screen.shape[1] == 0:
        raise ValueError("verts_screen has no vertices")
    if not 0 < image_size <= 32768:
        raise ValueError(f"image_size must lie in [1, 32768], got {image_size}")
    if cull_sign not in (-1, 0, 1):
        raise ValueError(f"cull_sign must be -1, 0 or 1, got {cull_sign}")


def _launcher():
    fn = load_library("coverage").coverage_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def coverage(verts_screen: torch.Tensor, faces: torch.Tensor, image_size: int, cull_sign: int = 0):
    """K3: silhouette coverage of the kept faces.

    :param verts_screen: (M, V, 3) float32 screen coordinates (x = column,
        y = row, depth unused).
    :param faces: (F, 3) int32 vertex indices.
    :param cull_sign: 0 keeps all faces; ±1 keeps the faces whose signed
        screen area has that sign.
    :return: (mask (M, H, W) bool, overflow (M,) int32), H = W = image_size.
    """
    if verts_screen.device.type == "cpu":
        return coverage_plain(verts_screen, faces, image_size, cull_sign)
    refuse_grad("K3 (coverage)", verts_screen)
    _check(verts_screen, faces, image_size, cull_sign)
    m, v = verts_screen.shape[:2]
    band_rows, _ = band_plan(image_size)
    mask = torch.empty((m, image_size, image_size), dtype=torch.uint8, device=verts_screen.device)
    overflow = torch.zeros((m,), dtype=torch.int32, device=verts_screen.device)
    stream = torch.cuda.current_stream(verts_screen.device).cuda_stream
    rc = _launcher()(
        verts_screen.data_ptr(), faces.data_ptr(), mask.data_ptr(), overflow.data_ptr(),
        m, v, faces.shape[0], image_size, image_size, band_rows, cull_sign, stream,
    )
    if rc != 0:
        raise RuntimeError(f"coverage_launch failed with CUDA error {rc}")
    LAUNCHES["coverage"] += 1
    return mask.view(torch.bool), overflow
