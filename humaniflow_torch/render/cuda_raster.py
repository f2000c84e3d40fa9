"""Attribute rasterizer K4 (csrc/raster.cu) and its plain twin.

The counterpart of the training render's rasterizer in
`humaniflow_tpu/render/binned_rasterizer.py`: `rasterize_with_attrs` takes
the place of `rasterize_binned_with_attrs` (and `rasterize_binned`), whose
TPU kernel is `_make_kernel`.

Contract (K4 and its twin `raster_plain`): an exact z-buffer over the kept
faces.  A face is kept when its nine screen coordinates are finite, its
vertex indices lie in [0, V), |signed area| > 1e-9, and signed area ·
cull_sign > 0 unless cull_sign is 0.  Pixel centres (col + 0.5, row + 0.5)
in the face's bounding box widened by one pixel are tested with the
edge-plane coefficients of `_edge_plane_coeffs`: w0 = a0·x + b0·y + c0,
w1 = a1·x + b1·y + c1, w2 = 1 − w0 − w1, inside when all three are ≥ 0;
z = za·x + zb·y + zc must be finite and below BIG_DEPTH.  The smallest z
wins, ties going to the lowest face id.  Outputs at the winner: depth, the
face id and (w0, w1), the linear attributes d0·w0 + d1·w1 + c, the constant
attributes and (za, zb); BIG_DEPTH, −1 and zeros where no face wins.

The TPU kernel binned faces into strips of fixed capacity (`k_max`,
`row_cand`, `live_cap`, `tall_cap`) and reported the candidates it dropped.
K4 has no capacity: `overflow` (M,) counts only faces whose vertex indices
lie outside [0, V), which are dropped, and is 0 for any valid face table;
`live_drop` is always 0.

K4 (csrc/raster.cu, which describes the design) marks each kept face in
the bands of 8 rows its box meets (a first pass), then gives each (mesh,
tile) one block that keeps the tile's keys in shared memory and resolves
it itself; `tile_plan` picks the tile.  Each face's units are cut to its row
span, a bound proved against the rounded per-pixel formula: `span_constants`
and `row_spans` are its plain version, held exhaustively against the
formula in tests/test_torch_kernels_cpu.py.

`raster` computes the twin when the tensors lie on the CPU.  For CUDA
tensors it launches K4, or raises on a wrong dtype, device, layout or shape,
or when grad mode is on and an input requires grad (K4 has no backward); it
never falls back.  `LAUNCHES` counts its launches (both passes: one); the
spans of utils/tracing.py read it.
"""

import ctypes

import torch

from ..utils.cuda_build import load_library, refuse_grad
from ..utils.tracing import launch_counter
from .cuda_coverage import _edge_plane_coeffs
from .rasterizer import BIG_DEPTH, Fragments, chunk_sizes

LAUNCHES = launch_counter({"raster": 0})
TILE_KEYS = 4096  # keys a block holds by default: 32 KB of shared memory
MAX_TILE_KEYS = 20480  # csrc/raster.cu kMaxTileKeys: 160 KB
TILE_COLS = 256  # the widest tile


def tile_plan(image_size: int, keys: int = TILE_KEYS):
    """(tile rows, tile columns, row tiles, column tiles) of K4 at this image
    size: full rows of at most TILE_COLS columns, as many rows as `keys`
    64-bit keys hold (16 rows of 256 at 256²).  Every block of K4 owns one
    (mesh, tile) and walks all of the mesh's faces."""
    cols = min(image_size, TILE_COLS)
    rows = max(1, min(image_size, keys // cols))
    return rows, cols, -(-image_size // rows), -(-image_size // cols)

_EMPTY = torch.iinfo(torch.int64).max


SPAN_LIMIT = 2.0**100  # csrc/raster.cu kSpanLimit: faces whose margin sum S exceeds it are not culled
_Q_LIMIT = 2.0**20  # csrc/raster.cu kQLimit


def block_tile(block: int, meshes: int, row_tiles: int, col_tiles: int):
    """(mesh, row tile, column tile) of K4's block `block` (csrc/raster.cu
    raster_kernel): row tiles from the image's middle outwards, each taken
    for every mesh and column tile before the next."""
    k, rest = divmod(block, meshes * col_tiles)
    row_tile = (row_tiles - 1) // 2 + (1 if k & 1 else -1) * ((k + 1) // 2)
    return rest // col_tiles, row_tile, rest % col_tiles


def span_constants(coef: torch.Tensor, image_size: int):
    """Plain version of K4's per-face span constants (csrc/raster.cu
    span_setup), from float32 coefficients (…, 9) [a0 b0 c0 a1 b1 c1 …]:
    (ok, 2M, alphas (…, 3), reciprocals (…, 3)).  S = 1 + (|a0| + |a1|)·W +
    (|b0| + |b1|)·H + |c0| + |c1| in float32 in that order; ok when S ≤
    2^100; 2M = S·2^-19; alphas (a0, a1, −(a0 + a1)) and their float32
    reciprocals."""
    a0, b0, c0, a1, b1, c1 = coef[..., :6].unbind(-1)
    size = float(image_size)
    one = torch.ones_like(a0)
    s = ((((one + (a0.abs() + a1.abs()) * size) + (b0.abs() + b1.abs()) * size) + c0.abs()) + c1.abs())
    ok = s <= SPAN_LIMIT
    alphas = torch.stack([a0, a1, -(a0 + a1)], dim=-1)
    return ok, s * 2.0**-19, alphas, 1.0 / alphas


def row_spans(coef: torch.Tensor, consts, row: torch.Tensor):
    """Plain version of K4's row span (csrc/raster.cu row_span): the columns
    [lo, hi] of pixel row `row` (int, broadcast against coef's leading
    shape) outside which the face with float32 coefficients coef (…, 9) is
    inside at no pixel centre, by the rounded formula (lo > hi: at none);
    ±2^31 where no bound applies.  The bounds are proved in csrc/raster.cu;
    tests/test_torch_kernels_cpu.py checks them exhaustively."""
    ok, m2, alphas, recips = consts
    b0, c0, b1, c1 = coef[..., 1], coef[..., 2], coef[..., 4], coef[..., 5]
    gy = row.to(torch.float32) + 0.5
    beta0 = b0 * gy + c0
    beta1 = b1 * gy + c1
    beta2 = (1.0 - beta0) - beta1
    big = 2**31 - 1
    lo = torch.full(beta0.shape, -big, dtype=torch.int64)
    hi = torch.full(beta0.shape, big, dtype=torch.int64)
    empty = torch.zeros(beta0.shape, dtype=torch.bool)
    for i, beta in enumerate((beta0, beta1, beta2)):
        alpha, recip = alphas[..., i], recips[..., i]
        r = -m2 - beta
        q = r * recip
        fq = torch.floor(q).clamp(-_Q_LIMIT, _Q_LIMIT).to(torch.int64)
        pos, neg = alpha > 0, alpha < 0
        empty |= (pos & (q > _Q_LIMIT)) | (neg & (q < -_Q_LIMIT)) | ((alpha == 0) & (r > 0))
        lo = torch.where(pos & (q >= -_Q_LIMIT) & (q <= _Q_LIMIT), torch.maximum(lo, fq - 1), lo)
        hi = torch.where(neg & (q >= -_Q_LIMIT) & (q <= _Q_LIMIT), torch.minimum(hi, fq + 1), hi)
    lo = torch.where(ok, lo, -big)
    hi = torch.where(ok, hi, big)
    empty &= ok
    return torch.where(empty, big, lo), torch.where(empty, -big, hi)


def _keys(z: torch.Tensor, face_ids: torch.Tensor) -> torch.Tensor:
    """int64 keys ordered as K4's unsigned 64-bit (order-preserving bits of
    z) << 32 | face id: by z, then by face id."""
    bits = z.contiguous().view(torch.int32).to(torch.int64)
    ordered = torch.where(bits >= 0, bits + (1 << 31), -1 - bits)  # [0, 2^32), monotone in z
    return (ordered - (1 << 31)) * (1 << 32) + face_ids


def _decode(keys: torch.Tensor):
    """(z, face id) of keys made by _keys."""
    ordered = (keys >> 32) + (1 << 31)
    bits = torch.where(ordered >= (1 << 31), ordered - (1 << 31), -1 - ordered)
    return bits.to(torch.int32).view(torch.float32), (keys & 0xFFFFFFFF).to(torch.int32)


def raster_plain(verts_screen, faces, image_size, attrs=None, n_lin=0, z_grads=False, emit_frags=True,
                 cull_sign=0):
    """Plain PyTorch twin of K4, in chunks over meshes and faces, with K4's
    operation order.  Arguments and result as `raster`."""
    m, v = verts_screen.shape[:2]
    h = w = image_size
    f = faces.shape[0]
    dev = verts_screen.device
    faces = faces.to(device=dev, dtype=torch.long)
    index_ok = ((faces >= 0) & (faces < v)).all(dim=-1)
    faces = torch.where(index_ok[:, None], faces, torch.zeros_like(faces))
    mc, fc = chunk_sizes(m, f, h, w, face_chunk=512)
    cols = torch.arange(w, dtype=torch.float32, device=dev)
    rows = torch.arange(h, dtype=torch.float32, device=dev)
    gx, gy = (cols + 0.5)[None, None, None, :], (rows + 0.5)[None, None, :, None]
    best = torch.full((m, h, w), _EMPTY, dtype=torch.int64, device=dev)
    coef = torch.empty((m, f, 9), dtype=torch.float32, device=dev)
    for m0 in range(0, m, mc):
        tri = verts_screen[m0 : m0 + mc][:, faces]  # (mc, F, 3, 3)
        coef[m0 : m0 + mc] = c_all = _edge_plane_coeffs(tri.reshape(tri.shape[:2] + (9,)))
        x, y = tri[..., 0], tri[..., 1]
        x0, y0, x1, y1, x2, y2 = x[..., 0], y[..., 0], x[..., 1], y[..., 1], x[..., 2], y[..., 2]
        area = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0)
        keep = torch.isfinite(tri).all(dim=-1).all(dim=-1) & (torch.abs(area) > 1e-9) & index_ok
        if cull_sign != 0:
            keep &= (area * float(cull_sign)) > 0
        x_lo, x_hi = torch.floor(x.amin(-1)) - 1.0, torch.ceil(x.amax(-1)) + 1.0
        y_lo, y_hi = torch.floor(y.amin(-1)) - 1.0, torch.ceil(y.amax(-1)) + 1.0
        for f0 in range(0, f, fc):
            sl = slice(f0, f0 + fc)
            c = c_all[:, sl, :, None, None]
            w0 = (c[:, :, 0] * gx + c[:, :, 1] * gy) + c[:, :, 2]
            w1 = (c[:, :, 3] * gx + c[:, :, 4] * gy) + c[:, :, 5]
            w2 = (1.0 - w0) - w1
            z = (c[:, :, 6] * gx + c[:, :, 7] * gy) + c[:, :, 8]
            in_box = ((cols >= x_lo[:, sl, None, None]) & (cols <= x_hi[:, sl, None, None])
                      & (rows[:, None] >= y_lo[:, sl, None, None]) & (rows[:, None] <= y_hi[:, sl, None, None]))
            hit = ((w0 >= 0) & (w1 >= 0) & (w2 >= 0) & in_box & keep[:, sl, None, None]
                   & torch.isfinite(z) & (z < BIG_DEPTH))
            ids = torch.arange(f0, min(f0 + fc, f), device=dev)[None, :, None, None]
            keys = torch.where(hit, _keys(z, ids), _EMPTY)
            best[m0 : m0 + mc] = torch.minimum(best[m0 : m0 + mc], keys.amin(dim=1))

    mask = best != _EMPTY
    z_win, fid = _decode(torch.where(mask, best, 0))
    fid = torch.where(mask, fid, 0).long()
    c = torch.gather(coef, 1, fid.reshape(m, -1, 1).expand(m, h * w, 9)).reshape(m, h, w, 9)
    gx2, gy2 = (cols + 0.5)[None, None, :], (rows + 0.5)[None, :, None]
    w0 = (c[..., 0] * gx2 + c[..., 1] * gy2) + c[..., 2]
    w1 = (c[..., 3] * gx2 + c[..., 4] * gy2) + c[..., 5]
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    depth = torch.where(mask, z_win, BIG_DEPTH)
    frags = None
    if emit_frags:
        frags = (torch.where(mask, fid.to(torch.int32), -1), torch.where(mask, w0, zero), torch.where(mask, w1, zero))
    out_planes = []
    if attrs is not None:
        rows_px = torch.gather(attrs.expand(m, f, attrs.shape[-1]), 1,
                               fid.reshape(m, -1, 1).expand(m, h * w, attrs.shape[-1])).reshape(m, h, w, -1)
        for j in range(n_lin):
            out_planes.append((rows_px[..., 3 * j] * w0 + rows_px[..., 3 * j + 1] * w1) + rows_px[..., 3 * j + 2])
        out_planes += list(rows_px[..., 3 * n_lin:].unbind(-1))
    if z_grads:
        out_planes += [c[..., 6], c[..., 7]]
    planes = (torch.stack([torch.where(mask, p, zero) for p in out_planes], dim=-1) if out_planes else None)
    overflow = (~index_ok).sum().to(torch.int32).expand(m).contiguous()
    return depth, frags, planes, overflow


def _check(verts_screen, faces, attrs, image_size, cull_sign):
    """Raise unless K4 can take these arguments."""
    dev = verts_screen.device
    named = [("verts_screen", verts_screen, torch.float32, 3), ("faces", faces, torch.int32, 2)]
    if attrs is not None:
        named.append(("attrs", attrs, torch.float32, 3))
    for name, t, dtype, ndim in named:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor on {dev}, got {t.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.dim() != ndim:
            raise ValueError(f"{name} has shape {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if verts_screen.shape[-1] != 3 or faces.shape[-1] != 3 or verts_screen.shape[1] == 0:
        raise ValueError(f"verts_screen {tuple(verts_screen.shape)} / faces {tuple(faces.shape)}: expected "
                         f"(M, V, 3) with V > 0 / (F, 3)")
    if attrs is not None and (attrs.shape[0] not in (1, verts_screen.shape[0]) or attrs.shape[1] != faces.shape[0]):
        raise ValueError(f"attrs has shape {tuple(attrs.shape)}; expected (M or 1, F, R)")
    if not 0 < image_size <= 32768:
        raise ValueError(f"image_size must lie in [1, 32768], got {image_size}")
    if cull_sign not in (-1, 0, 1):
        raise ValueError(f"cull_sign must be -1, 0 or 1, got {cull_sign}")


def _launcher():
    fn = load_library("raster").raster_launch
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 11
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def raster(verts_screen, faces, image_size, attrs=None, n_lin=0, z_grads=False, emit_frags=True, cull_sign=0):
    """K4: the z-buffer of the kept faces with in-kernel attributes.

    :param verts_screen: (M, V, 3) float32 screen coordinates (x = column,
        y = row, depth).
    :param faces: (F, 3) int32 vertex indices.
    :param attrs: None or (M or 1, F, 3·n_lin + n_const) float32 per-face
        rows: (d0, d1, c) of each linear attribute, then the constants.
    :param cull_sign: 0 keeps all faces; ±1 keeps the faces whose signed
        screen area has that sign.
    :return: (depth (M, H, W), frags (face (M, H, W) int32, w0, w1) or None
        without emit_frags, planes (M, H, W, n_lin + n_const [+ 2]) or None,
        overflow (M,) int32); H = W = image_size.
    """
    if verts_screen.device.type == "cpu":
        return raster_plain(verts_screen, faces, image_size, attrs, n_lin, z_grads, emit_frags, cull_sign)
    refuse_grad("K4 (raster)", verts_screen, attrs)
    _check(verts_screen, faces, attrs, image_size, cull_sign)
    out = _raster_launch(verts_screen, faces, image_size, attrs, n_lin, z_grads, emit_frags, cull_sign,
                         tile_plan(image_size))
    LAUNCHES["raster"] += 1
    return out


def _raster_launch(verts_screen, faces, image_size, attrs, n_lin, z_grads, emit_frags, cull_sign, tile):
    """Launch K4 on checked arguments with `tile` = tile_plan(...)[:2] or
    more: (tile rows, tile columns)."""
    m, v = verts_screen.shape[:2]
    f = faces.shape[0]
    n_const = 0 if attrs is None else attrs.shape[-1] - 3 * n_lin
    if n_lin < 0 or n_const < 0:
        raise ValueError(f"attrs rows of width {attrs.shape[-1]} cannot hold {n_lin} linear attributes")
    n_attr = n_lin + n_const + (2 if z_grads else 0)
    dev = verts_screen.device
    hw = (m, image_size, image_size)
    depth = torch.empty(hw, dtype=torch.float32, device=dev)
    frags = None
    if emit_frags:
        frags = (torch.empty(hw, dtype=torch.int32, device=dev), torch.empty(hw, dtype=torch.float32, device=dev),
                 torch.empty(hw, dtype=torch.float32, device=dev))
    planes = torch.empty(hw + (n_attr,), dtype=torch.float32, device=dev) if n_attr else None
    overflow = torch.empty((m,), dtype=torch.int32, device=dev)
    # scratch: per mesh and band of 8 rows, a bit for each kept face whose box meets the band
    bands = torch.empty((m, -(-image_size // 8), -(-f // 32)), dtype=torch.int32, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    stride = 0 if attrs is None or attrs.shape[0] == 1 else f * attrs.shape[-1]
    rc = _launcher()(
        verts_screen.data_ptr(), faces.data_ptr(), ptr(attrs), stride, depth.data_ptr(),
        *(ptr(t) for t in (frags or (None, None, None))), ptr(planes), overflow.data_ptr(), bands.data_ptr(),
        m, v, f, image_size, image_size, tile[0], tile[1], n_lin, n_const, int(z_grads), cull_sign,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"raster_launch failed with CUDA error {rc}")
    return depth, frags, planes, overflow


def rasterize_with_attrs(verts_screen, faces, image_size, lin_attrs=None, const_attrs=None, z_grads=False,
                         emit_frags=True, cull_sign=0):
    """The port's `rasterize_binned_with_attrs`: K4 on CUDA, its twin on the
    CPU.

    :param verts_screen: (B, V, 3) screen coordinates.
    :param faces: (F, 3) vertex indices.
    :param lin_attrs: (B|1, F, 3, K_lin) per-face-vertex values,
        barycentrically interpolated.
    :param const_attrs: (B|1, F, K_const) per-face constants.
    :param z_grads: also emit the winner's (za, zb) depth gradients.
    :param emit_frags: False leaves the fragments' face ids and barycentrics
        out (the mask and depth remain).
    :return: (Fragments, planes (B, H, W, K_lin + K_const [+ 2]) or None,
        overflow (B,) int32, live_drop (B,) int32 ≡ 0).
    """
    b, f = verts_screen.shape[0], faces.shape[0]
    rows = []
    if lin_attrs is not None:
        av = lin_attrs.to(torch.float32)
        rows.append(torch.stack([av[..., 0, :] - av[..., 2, :], av[..., 1, :] - av[..., 2, :], av[..., 2, :]],
                                dim=-1).reshape(av.shape[0], f, -1))
    if const_attrs is not None:
        rows.append(const_attrs.to(torch.float32))
    attrs = None
    if rows:
        lead = max(r.shape[0] for r in rows)
        attrs = torch.cat([r.expand(lead, f, r.shape[-1]) for r in rows], dim=-1).contiguous()
    n_lin = 0 if lin_attrs is None else lin_attrs.shape[-1]
    depth, frags, planes, overflow = raster(verts_screen.contiguous(), faces.contiguous(), image_size, attrs, n_lin,
                                            z_grads, emit_frags, cull_sign)
    mask = depth < BIG_DEPTH
    if frags is not None:
        face, b0, b1 = frags
        bary = torch.where(mask[..., None], torch.stack([b0, b1, 1.0 - b0 - b1], dim=-1), 0.0)
    else:
        face = torch.where(mask, 0, -1).to(torch.int32)
        bary = torch.zeros(depth.shape + (3,), dtype=torch.float32, device=depth.device)
    return Fragments(face_idx=face, bary=bary, depth=depth), planes, overflow, torch.zeros_like(overflow)
