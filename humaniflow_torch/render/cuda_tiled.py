"""Tile-culled rasterization kernel K6 (csrc/tiled_raster.cu) and its plain twin.

The counterpart of `humaniflow_tpu/render/pallas_rasterizer.py`
(`rasterize_pallas` with its kernel `_raster_kernel`, and
`sort_faces_by_row`): the renderer's exact "tiled" backend.

Contract (both functions): `rasterize`'s (render/rasterizer.py) fragments of
the faces in the order given: per mesh and pixel centre (col + 0.5,
row + 0.5), barycentrics w0, w1 from the edge functions times 1/area and
w2 = 1 − w0 − w1; the face is inside when all three are ≥ 0 and
|area| > 1e-9, at depth z = w0·z0 + w1·z1 + w2·z2.  Faces are walked in
chunks of 64, and a chunk is skipped for a 32×128 pixel tile when its screen
bounds (over its real faces; a NaN coordinate makes them NaN, and the chunk
is skipped everywhere, as `jnp.min` makes the TPU kernel do) miss the tile.
Within the walked faces the smallest z < BIG_DEPTH wins, the lowest face
index on a tie; a NaN depth never wins.  face_idx is −1 where nothing won.

The twin is `rasterize_tiled_plain`: the exact scan behind
`rasterizer.rasterize` (`zbuffer_scan`, the same formulas and tie rule) given
the culling as a per-tile live mask, under which a NaN depth never wins
(the plain scan lets it poison its chunk's minimum).  On finite input the
two agree.

Inside a walked chunk K6 also skips, per warp, the faces that provably cover
no pixel centre of the warp's 4×8 pixel sub-block, by the per-face linear
tests `cull_constants` computes and `may_cover` evaluates (their plain
versions here, the same formulas and margins as csrc/tiled_raster.cu): a
face is skipped only where one of its three barycentrics, as the per-pixel
float32 formula rounds it, is negative at every centre of the sub-block, so
the fragments stay the twin's bit for bit.

`rasterize_tiled` computes the twin when the tensors lie on the CPU.  For
CUDA tensors it launches K6, or raises on a wrong dtype, device, layout or
shape; it never falls back.  K6 has no backward: on CUDA the wrapper raises
when grad mode is on and verts_screen requires grad.  `LAUNCHES` counts its
launches, which the spans of utils/tracing.py read.
"""

import ctypes

import numpy as np
import torch

from ..utils.cuda_build import load_library, refuse_grad
from ..utils.tracing import launch_counter
from .rasterizer import BIG_DEPTH, Fragments, zbuffer_scan

LAUNCHES = launch_counter({"tiled_raster": 0})

BLOCK_ROWS = 32  # the culling tile
BLOCK_COLS = 128
FACE_CHUNK = 64
SUB_ROWS, SUB_COLS = 4, 8  # a warp's pixel sub-block in K6
_PACK = 16  # floats per packed face in K6's scratch
_CULL = 12  # floats of cull constants per face in K6's scratch
# Margins of the cull (derived in csrc/tiled_raster.cu): relative to the
# bound on the per-pixel formula's magnitudes, and absolute floors that keep
# a skipped barycentric away from underflow to -0.
_REL = 2.0 ** -17
_FLOOR, _FLOOR_W = 2.0 ** -100, 2.0 ** -84
_LIMIT = 2.0 ** 40  # coordinates beyond this (or |area| beyond 2**40) are never skipped


def sort_faces_by_row(verts_rest: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Faces sorted by the row of their rest-pose centroid, for culling
    coherence."""
    cy = np.asarray(verts_rest)[np.asarray(faces)].mean(axis=1)[:, 1]
    return np.ascontiguousarray(np.asarray(faces)[np.argsort(cy)])


def tile_sort_order(verts_screen0: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    """The face order the renderer's tiled backend uses: a stable sort by the
    (row-block, col-block) tile bucket of each face's screen centroid on one
    mesh, key = (cy // 32)·64 + (cx // 128), so that a chunk's faces share
    tiles and the culling skips most (tile, chunk) pairs."""
    tri = verts_screen0[faces.long()]  # (F, 3, 3)
    c = (tri[:, 0] + tri[:, 1] + tri[:, 2]) / 3.0
    key = (torch.floor(c[:, 1] / BLOCK_ROWS).to(torch.int32) * 64
           + torch.floor(c[:, 0] / BLOCK_COLS).to(torch.int32))
    return torch.argsort(key, stable=True)


def _check_size(image_size: int):
    if image_size <= 0 or image_size % BLOCK_ROWS or image_size % BLOCK_COLS:
        raise ValueError(f"image_size must be a positive multiple of {BLOCK_COLS}, got {image_size}")


def _chunk_bounds(tri: torch.Tensor, f: int):
    """Per-chunk screen bounds (ymin, ymax, xmin, xmax), each (B, C), over the
    real faces of tri (B, F, 3, 3); NaN propagates."""
    b = tri.shape[0]
    c = -(-f // FACE_CHUNK)
    pad = c * FACE_CHUNK - f

    def reduce(t, fill, fn):
        t = fn(t, dim=-1)  # (B, F)
        t = torch.cat([t, t.new_full((b, pad), fill)], dim=1)
        return fn(t.reshape(b, c, FACE_CHUNK), dim=-1)

    xs, ys = tri[..., 0], tri[..., 1]
    return (reduce(ys, BIG_DEPTH, torch.amin), reduce(ys, -BIG_DEPTH, torch.amax),
            reduce(xs, BIG_DEPTH, torch.amin), reduce(xs, -BIG_DEPTH, torch.amax))


def rasterize_tiled_plain(verts_screen: torch.Tensor, faces: torch.Tensor, image_size: int) -> Fragments:
    """Plain PyTorch twin of K6: the exact scan `rasterizer.zbuffer_scan`
    with each face live only for the tiles its chunk's bounds meet.

    :param verts_screen: (B, V, 3) float32 screen coordinates (x = column,
        y = row, depth).
    :param faces: (F, 3) vertex indices in [0, V), ideally sorted by tile
        (tile_sort_order).
    :param image_size: H = W, a multiple of 128.
    """
    _check_size(image_size)
    dev = verts_screen.device
    faces = faces.to(device=dev, dtype=torch.long)
    ymin, ymax, xmin, xmax = _chunk_bounds(verts_screen[:, faces], faces.shape[0])
    row0 = (torch.arange(image_size // BLOCK_ROWS, device=dev) * BLOCK_ROWS).to(torch.float32)[:, None]
    col0 = (torch.arange(image_size // BLOCK_COLS, device=dev) * BLOCK_COLS).to(torch.float32)[None, :]
    e = lambda t: t[..., None, None]  # noqa: E731
    live = ((e(ymax) >= row0) & (e(ymin) <= row0 + BLOCK_ROWS)
            & (e(xmax) >= col0) & (e(xmin) <= col0 + BLOCK_COLS))  # (B, C, H/32, W/128)

    def live_fn(m0, m1, ids):
        return (live[m0:m1][:, ids // FACE_CHUNK]
                .repeat_interleave(BLOCK_ROWS, dim=2).repeat_interleave(BLOCK_COLS, dim=3))

    return zbuffer_scan(verts_screen, faces, image_size, live_fn=live_fn)


def cull_constants(verts_screen: torch.Tensor, faces: torch.Tensor, image_size: int) -> torch.Tensor:
    """K6's per-face cull constants, (M, F, 12) float32: for each of the
    three tests t (w0, w1, w2) a linear function (α_t, β_t, k_t) of a 4×8
    sub-block's centre, laid out [α0 β0 k0 α1 β1 k1 α2 β2 k2 0 0 0].  A face
    that is not inside anywhere (|area| ≤ 1e-9, NaN, an index outside
    [0, V)) gets k = −1 (always skipped), one beyond the float32-safe range
    k = +inf (never skipped).  Computed in float64 from the float32 values
    the per-pixel formula reads, in the kernel's order of operations."""
    m, v = verts_screen.shape[:2]
    fl = faces.to(device=verts_screen.device, dtype=torch.long)
    in_range = ((fl >= 0) & (fl < v)).all(dim=-1)
    tri = verts_screen.to(torch.float32)[:, fl.clamp(0, v - 1)]  # (M, F, 3, 3)
    x0, y0, x1, y1, x2, y2 = (tri[..., i, j] for i in range(3) for j in range(2))
    dx0, dy0, dx1, dy1 = x2 - x1, y2 - y1, x0 - x2, y0 - y2
    area = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0)
    valid = (torch.abs(area) > 1e-9) & in_range
    inv = torch.where(valid, 1.0 / torch.where(valid, area, torch.ones_like(area)), torch.zeros_like(area))
    X1, Y1, X2, Y2, DX0, DY0, DX1, DY1, INV = (t.double() for t in (x1, y1, x2, y2, dx0, dy0, dx1, dy1, inv))
    ai = INV.abs()
    ok = (valid & (ai >= 1.0 / _LIMIT) & (X1.abs() <= _LIMIT) & (Y1.abs() <= _LIMIT) & (X2.abs() <= _LIMIT)
          & (Y2.abs() <= _LIMIT) & (DX0.abs() <= 2 * _LIMIT) & (DY0.abs() <= 2 * _LIMIT)
          & (DX1.abs() <= 2 * _LIMIT) & (DY1.abs() <= 2 * _LIMIT))
    s = torch.where(INV > 0, 1.0, -1.0).double()
    h1, w1 = float(image_size + 1), float(image_size + 1)
    hx, hy = (SUB_COLS - 1) / 2, (SUB_ROWS - 1) / 2
    c0 = DY0 * X1 - DX0 * Y1
    c1 = DY1 * X2 - DX1 * Y2
    a0 = DX0.abs() * (h1 + Y1.abs()) + DY0.abs() * (w1 + X1.abs())
    a1 = DX1.abs() * (h1 + Y2.abs()) + DY1.abs() * (w1 + X2.abs())
    f0 = _FLOOR * ((1.0 + DX0.abs()) + DY0.abs()) + _FLOOR_W
    f1 = _FLOOR * ((1.0 + DX1.abs()) + DY1.abs()) + _FLOOR_W
    k0 = (((s * c0) + DY0.abs() * hx) + DX0.abs() * hy) + (_REL * a0 + f0)
    k1 = (((s * c1) + DY1.abs() * hx) + DX1.abs() * hy) + (_REL * a1 + f1)
    al2 = (INV * (DY0 + DY1)).float().double()
    be2 = (-(INV * (DX0 + DX1))).float().double()
    g2 = 1.0 - INV * (c0 + c1)
    sumd = (((1.0 + DX0.abs()) + DY0.abs()) + DX1.abs()) + DY1.abs()
    m2 = _REL * (1.0 + ai * (a0 + a1)) + _FLOOR * ((1.0 + ai) * sumd)
    k2 = ((g2 + al2.abs() * hx) + be2.abs() * hy) + m2
    zero = torch.zeros_like(X1)
    q = torch.stack([(-s) * DY0, s * DX0, k0, (-s) * DY1, s * DX1, k1, al2, be2, k2, zero, zero, zero], dim=-1)
    never = torch.tensor([0.0, 0.0, float("inf")] * 3 + [0.0] * 3, dtype=torch.float64, device=q.device)
    always = torch.tensor([0.0, 0.0, -1.0] * 3 + [0.0] * 3, dtype=torch.float64, device=q.device)
    q = torch.where(ok[..., None], q, never)
    return torch.where(valid[..., None], q, always).float()


def may_cover(consts: torch.Tensor, row0, col0) -> torch.Tensor:
    """Plain version of K6's cull: False only where the face provably covers
    no pixel centre of the 4×8 sub-block whose top-left pixel is
    (row0, col0), i.e. where one test t has α_t·cx + (β_t·cy + k_t) < 0 at
    the sub-block's centre (cx, cy), evaluated in float32 with one rounding
    per operation, as the kernel does.  consts (..., 12) from cull_constants;
    row0 and col0 broadcast against consts[..., 0]."""
    cx = torch.as_tensor(col0, device=consts.device).to(torch.float32) + SUB_COLS / 2
    cy = torch.as_tensor(row0, device=consts.device).to(torch.float32) + SUB_ROWS / 2
    skip = torch.zeros(torch.broadcast_shapes(consts.shape[:-1], cx.shape, cy.shape), dtype=torch.bool,
                       device=consts.device)
    for t in range(3):
        al, be, k = consts[..., 3 * t], consts[..., 3 * t + 1], consts[..., 3 * t + 2]
        skip |= al * cx + (be * cy + k) < 0
    return ~skip


def _check(verts_screen: torch.Tensor, faces: torch.Tensor, image_size: int):
    """Raise unless K6 can take these arguments."""
    dev = verts_screen.device
    for name, t, dtype in (("verts_screen", verts_screen, torch.float32), ("faces", faces, torch.int32)):
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor on {dev}, got {t.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.dim() != (3 if name == "verts_screen" else 2) or t.shape[-1] != 3:
            raise ValueError(f"{name} has shape {tuple(t.shape)}; expected (B, V, 3) / (F, 3)")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if verts_screen.shape[1] == 0 or faces.shape[0] == 0:
        raise ValueError("verts_screen has no vertices or faces is empty")
    if verts_screen.shape[0] > 65535:
        raise ValueError(f"at most 65535 meshes per launch, got {verts_screen.shape[0]}")
    _check_size(image_size)


def _launcher():
    fn = load_library("tiled_raster").tiled_raster_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def rasterize_tiled(verts_screen: torch.Tensor, faces: torch.Tensor, image_size: int) -> Fragments:
    """K6: tile-culled exact rasterization (same contract as
    rasterizer.rasterize; see the module docstring).

    :param verts_screen: (B, V, 3) float32 screen coordinates.
    :param faces: (F, 3) int32 vertex indices, ideally sorted by tile
        (tile_sort_order); K6 treats a face with an index outside [0, V) as
        never inside.
    :param image_size: H = W, a multiple of 128.
    """
    if verts_screen.device.type == "cpu":
        return rasterize_tiled_plain(verts_screen, faces, image_size)
    refuse_grad("K6 (rasterize_tiled)", verts_screen)
    _check(verts_screen, faces, image_size)
    m, v = verts_screen.shape[:2]
    f = faces.shape[0]
    c = -(-f // FACE_CHUNK)
    dev = verts_screen.device
    tri = torch.empty((m, c * FACE_CHUNK, _PACK), dtype=torch.float32, device=dev)
    cull = torch.empty((m, c * FACE_CHUNK, _CULL), dtype=torch.float32, device=dev)
    bounds = torch.empty((m, c, 4), dtype=torch.float32, device=dev)
    depth = torch.empty((m, image_size, image_size), dtype=torch.float32, device=dev)
    face_idx = torch.empty((m, image_size, image_size), dtype=torch.int32, device=dev)
    bary = torch.empty((m, image_size, image_size, 3), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _launcher()(
        verts_screen.data_ptr(), faces.data_ptr(), tri.data_ptr(), cull.data_ptr(), bounds.data_ptr(),
        depth.data_ptr(), face_idx.data_ptr(), bary.data_ptr(), m, v, f, image_size, image_size, stream,
    )
    if rc != 0:
        raise RuntimeError(f"tiled_raster_launch failed with CUDA error {rc}")
    LAUNCHES["tiled_raster"] += 1
    return Fragments(face_idx=face_idx, bary=bary, depth=depth)
