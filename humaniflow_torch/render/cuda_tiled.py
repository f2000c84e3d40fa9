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

`rasterize_tiled` computes the twin when the tensors lie on the CPU.  For
CUDA tensors it launches K6, or raises on a wrong dtype, device, layout or
shape; it never falls back.  K6 has no backward: on CUDA the wrapper raises
when grad mode is on and verts_screen requires grad.  `LAUNCHES` counts its
launches.
"""

import ctypes

import numpy as np
import torch

from ..utils.cuda_build import load_library, refuse_grad
from .rasterizer import BIG_DEPTH, Fragments, zbuffer_scan

LAUNCHES = {"tiled_raster": 0}

BLOCK_ROWS = 32  # the culling tile
BLOCK_COLS = 128
FACE_CHUNK = 64
_PACK = 16  # floats per packed face in K6's scratch


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
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
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
    bounds = torch.empty((m, c, 4), dtype=torch.float32, device=dev)
    depth = torch.empty((m, image_size, image_size), dtype=torch.float32, device=dev)
    face_idx = torch.empty((m, image_size, image_size), dtype=torch.int32, device=dev)
    bary = torch.empty((m, image_size, image_size, 3), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _launcher()(
        verts_screen.data_ptr(), faces.data_ptr(), tri.data_ptr(), bounds.data_ptr(), depth.data_ptr(),
        face_idx.data_ptr(), bary.data_ptr(), m, v, f, image_size, image_size, stream,
    )
    if rc != 0:
        raise RuntimeError(f"tiled_raster_launch failed with CUDA error {rc}")
    LAUNCHES["tiled_raster"] += 1
    return Fragments(face_idx=face_idx, bary=bary, depth=depth)
