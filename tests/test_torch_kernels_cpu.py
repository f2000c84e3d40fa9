"""K2's restructured backward, K3's band plan, K6's cull, K2's forward plan,
K4's tile plan and K1's row chunks on the CPU.

K2's backward is a per-vertex part, (dp, G12), computed by a kernel on the
card and by its plain twin here, followed by float32 products over V.  The
twin and the whole backward are held against the JAX package's custom VJP
(`_lbs_bwd`, `_fused_bwd` of humaniflow_tpu/models/pallas_lbs.py) on the
same numpy inputs.  K3's band plan and K4's tile plan are checked to cover
every row (every pixel) once within their shared-memory budgets, K1's row
chunks every row of a group once with no empty slot, and K4's row spans
never to drop a pixel the per-pixel formula finds inside.  K6's cull (the
plain versions of the kernel's per-face constants and test,
render/cuda_tiled.py) is held against
the per-pixel float32 formula of the exact scan on near-degenerate faces:
it never skips a face that the formula finds inside a pixel centre of the
sub-block; and on posed bodies it skips most (face, sub-block) pairs.  The
kernels themselves are held against the twins on the card in
tests/test_torch_kernels.py.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import rel_err, t

import humaniflow_tpu.models.pallas_lbs as jlbs
from humaniflow_torch.models import cuda_lbs
from humaniflow_torch.render import cuda_coverage, cuda_raster, cuda_tiled
from humaniflow_torch.render.rasterizer import _barycentrics
from humaniflow_torch.utils.profiling import sliver_case

# Adjoints: within 1e-5 of each tensor's largest |value| (float32 sums in
# another order; the same bound as K2's gradient against autograd).
K2_GRAD_RTOL = 1e-5
V, B, NB = 500, 3, 10


def _inputs(seed=0):
    """Port-layout inputs (a12, betas, pose_feature, v_template_cm,
    shapedirs_cm, posedirs_cm, lbs_weights) and a cotangent, as numpy."""
    rng = np.random.default_rng(seed)
    r = lambda *s, sc=1.0: (sc * rng.normal(size=s)).astype(np.float32)  # noqa: E731
    args = (
        r(B, 24, 12, sc=0.5), r(B, NB), r(B, 207, sc=0.5), r(3, V, sc=0.3), r(NB, 3, V, sc=0.01),
        r(207, 3, V, sc=0.001), rng.dirichlet(np.ones(24), size=V).astype(np.float32),
    )
    return args, r(B, 3, V)


def _jax_layout(args):
    """The same inputs in smpl_verts_fused's argument order and layouts:
    (W, a12, betas, pose_feature, v_template_cm, shapedirs (3, V, NB),
    posedirs (207, V·3) with (v, c)-major columns)."""
    a12, betas, pf, vt, sd, pd, w = (jnp.asarray(a) for a in args)
    return w, a12, betas, pf, vt, sd.transpose(1, 2, 0), pd.transpose(0, 2, 1).reshape(207, 3 * V)


def test_k2_backward_vertex_twin_matches_jax_lbs_bwd():
    args, g = _inputs()
    w, a12, betas, pf, vt, sd, pd = _jax_layout(args)
    hi = "highest"
    pd_cm = pd.reshape(-1, V, 3).transpose(0, 2, 1).reshape(-1, 3 * V)
    p = vt + jnp.einsum("bl,cvl->bcv", betas, sd, precision=hi) + jnp.matmul(pf, pd_cm, precision=hi).reshape(-1, 3, V)
    _, _, want_dp = jlbs._lbs_bwd((w, a12, p), jnp.asarray(g))
    # G12 as _lbs_bwd builds it (pallas_lbs.py:404-407)
    gp = jnp.einsum("bcv,biv->bciv", jnp.asarray(g), p, precision=hi).reshape(B, 9, V)
    want_g12 = jnp.concatenate([gp, jnp.asarray(g)], axis=1)
    dp, g12 = cuda_lbs.smpl_verts_backward_vertex(t(g), True, True, *(t(a) for a in args))
    assert dp.shape == (B, 3, V) and g12.shape == (B, 12, V)
    assert rel_err(dp.numpy(), want_dp) <= K2_GRAD_RTOL
    assert rel_err(g12.numpy(), want_g12) <= K2_GRAD_RTOL
    # the wrapper on CPU tensors is the plain twin
    twin = cuda_lbs.smpl_verts_backward_vertex_plain(t(g), True, True, *(t(a) for a in args))
    assert torch.equal(twin[0], dp) and torch.equal(twin[1], g12)


def test_k2_backward_matches_jax_fused_bwd():
    args, g = _inputs(seed=1)
    jw, ja12, jbetas, jpf, jvt, jsd, jpd = _jax_layout(args)
    want = jlbs._fused_bwd((jw, ja12, jbetas, jpf, jvt, jsd, jpd), jnp.asarray(g))
    want = dict(zip(("dw", "da12", "dbetas", "dpf", "dvt", "dsd", "dpd"), (np.asarray(x) for x in want)))
    want["dsd"] = want["dsd"].transpose(2, 0, 1)  # (3, V, NB) → (NB, 3, V)
    want["dpd"] = want["dpd"].reshape(207, V, 3).transpose(0, 2, 1)  # → (207, 3, V)
    got = cuda_lbs.smpl_verts_backward(t(g), [True] * 7, *(t(a) for a in args))
    names = ("da12", "dbetas", "dpf", "dvt", "dsd", "dpd", "dw")
    for name, a in zip(names, got):
        assert a.shape == want[name].shape, name
        assert rel_err(a.numpy(), want[name]) <= K2_GRAD_RTOL, name


@pytest.mark.parametrize(
    "needs",
    [(True, True, True, False, False, False, False),  # train step and optimise: a12, betas, pose feature
     (False, True, False, False, False, False, False),  # betas alone: dp, no G12
     (True, False, False, False, False, False, True),  # a12 and W: G12, no dp
     (False, False, False, True, True, True, False)],  # the model tensors: dp only
)
def test_k2_backward_returns_only_what_is_needed(needs):
    args, g = _inputs(seed=2)
    targs = [t(a) for a in args]
    full = cuda_lbs.smpl_verts_backward(t(g), [True] * 7, *targs)
    part = cuda_lbs.smpl_verts_backward(t(g), list(needs), *targs)
    for i, (need, a, f) in enumerate(zip(needs, part, full)):
        if need:
            torch.testing.assert_close(a, f, rtol=0, atol=0, msg=f"input {i}")
        else:
            assert a is None, i
    dp, g12 = cuda_lbs.smpl_verts_backward_vertex(t(g), any(needs[1:6]), needs[0] or needs[6], *targs)
    assert (dp is None) == (not any(needs[1:6])) and (g12 is None) == (not (needs[0] or needs[6]))


@pytest.mark.parametrize("size", [1, 33, 200, 256, 1024, 32768])
def test_k3_band_plan_covers_every_row_once_within_the_budget(size):
    rows, bands = cuda_coverage.band_plan(size)
    words_per_row = -(-size // 32)
    assert 1 <= rows <= size and rows * words_per_row <= cuda_coverage.BAND_WORDS
    covered = np.zeros(size, np.int64)
    for band in range(bands):
        covered[band * rows : min(size, (band + 1) * rows)] += 1
    assert (covered == 1).all()
    assert (bands - 1) * rows < size  # no empty band
    if size <= 512:
        assert bands == 1  # the whole image in one band


def _cull_soup(rng, n=600):
    """n faces of three own vertices around a 128² image: ordinary, on the
    pixel grid (vertices on centres and corners), huge (coordinates up to
    1e7, some beyond the cull's 2**40 range) and zero-area."""
    k = n // 4
    c = rng.uniform(-20, 148, size=(n, 1, 2))
    xy = np.concatenate([
        c[:k] + rng.normal(scale=6, size=(k, 3, 2)),
        np.floor(c[k:2 * k] + rng.normal(scale=5, size=(k, 3, 2))) + rng.choice([0.0, 0.5], size=(k, 3, 2)),
        c[2 * k:3 * k] + rng.normal(size=(k, 3, 2)) * 10 ** rng.uniform(2, 13, size=(k, 1, 1)),
        c[3 * k:] + rng.normal(scale=4, size=(n - 3 * k, 1, 2)) * np.array([0.0, 1.0, 2.0])[None, :, None],
    ])
    verts = np.concatenate([xy, np.zeros((n, 3, 1))], -1).reshape(1, 3 * n, 3).astype(np.float32)
    return torch.from_numpy(verts), torch.arange(3 * n).reshape(n, 3)


def test_k6_cull_never_skips_a_face_the_rounded_formula_finds_inside():
    """Every (face, 4×8 sub-block) pair of a 128² image, for the 2,400
    near-degenerate faces of utils/profiling.py::sliver_case on both its
    meshes and 600 more: wherever the exact scan's float32 formula puts a
    pixel centre of the sub-block inside the face, may_cover is True.  The
    slivers' rounding claims pixel centres outside their boxes, so the case
    is one a box test would get wrong."""
    img = 128
    sv, faces = sliver_case(img, device="cpu")
    soup, soup_faces = _cull_soup(np.random.default_rng(3))
    cases = [(sv, faces.long()), (soup, soup_faces)]
    gy = (torch.arange(img, dtype=torch.float32) + 0.5)[:, None]
    gx = (torch.arange(img, dtype=torch.float32) + 0.5)[None, :]
    row0 = (torch.arange(img // cuda_tiled.SUB_ROWS) * cuda_tiled.SUB_ROWS)[:, None]
    col0 = (torch.arange(img // cuda_tiled.SUB_COLS) * cuda_tiled.SUB_COLS)[None, :]
    pairs = dropped = claimed = outside_box = 0
    for verts, f in cases:
        consts = cuda_tiled.cull_constants(verts, f, img)
        for f0 in range(0, f.shape[0], 600):
            tri = verts[:, f[f0:f0 + 600]]
            w0, w1, w2, valid = _barycentrics(tri, gx, gy)
            inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0) & valid  # (M, n, H, W)
            hit = inside.reshape(*inside.shape[:2], img // cuda_tiled.SUB_ROWS, cuda_tiled.SUB_ROWS,
                                 img // cuda_tiled.SUB_COLS, cuda_tiled.SUB_COLS).any(3).any(-1)
            cover = cuda_tiled.may_cover(consts[:, f0:f0 + 600, None, None, :], row0, col0)
            pairs += cover.numel()
            dropped += int((hit & ~cover).sum())
            claimed += int(hit.sum())
            lo, hi = tri[..., :2].amin(-2), tri[..., :2].amax(-2)  # (M, n, 2)
            box = lambda t, i: t[..., i, None, None]  # noqa: E731
            outside_box += int((inside & ((gx < box(lo, 0)) | (gx > box(hi, 0)) | (gy < box(lo, 1))
                                          | (gy > box(hi, 1)))).sum())
    assert pairs >= 100_000 and claimed > 1000
    assert outside_box > 0
    assert dropped == 0


def test_k6_cull_constants_mark_faces_never_and_always_walked():
    """A zero-area face, one with a NaN vertex and one with an index out of
    range are always skipped (k = −1); one with a coordinate beyond 2**40 is
    never skipped (k = +inf); an ordinary face is skipped far from itself
    and kept over itself."""
    v = torch.tensor([[[10.0, 10.0, 0], [20.0, 10.0, 0], [10.0, 20.0, 0], [30.0, 30.0, 0], [40.0, 40.0, 0],
                       [math.nan, 5.0, 0], [2e12, 5.0, 0]]])
    faces = torch.tensor([[0, 1, 2], [0, 3, 4], [5, 1, 2], [0, 1, 9], [6, 1, 2]])
    consts = cuda_tiled.cull_constants(v, faces, 128)[0]
    k = consts[:, 2::3][:, :3]
    assert (k[1:4] == -1).all() and torch.isinf(k[4]).all() and (k[4] > 0).all()
    assert not bool(cuda_tiled.may_cover(consts[1:4], 8, 8).any())
    assert bool(cuda_tiled.may_cover(consts[4], 96, 96))
    assert bool(cuda_tiled.may_cover(consts[0], 8, 8)) and not bool(cuda_tiled.may_cover(consts[0], 64, 64))


def test_k6_cull_skips_most_pairs_on_posed_bodies():
    """On two posed synthetic bodies as the visualisation renders them
    (256², tile-sorted DensePose faces), the cull skips most of the (face,
    sub-block) pairs of the live (tile, chunk) pairs that K6 evaluates, so
    that it walks about the z-buffer's own work: the walked pixel tests stay
    within twice the pixels of the faces' widened boxes."""
    from humaniflow_torch.models import smpl_forward, synthetic_smpl
    from humaniflow_torch.ops import aa_rotate_translate_points, so3_exp
    from humaniflow_torch.render import TexturedIUVRenderer

    img, b = 256, 2
    renderer = TexturedIUVRenderer(img_wh=img, projection_type="orthographic", device="cpu")
    g = torch.Generator().manual_seed(71)
    pose = so3_exp(0.25 * torch.randn((b, 24, 3), generator=g))
    verts = smpl_forward(synthetic_smpl(num_verts=6890, device="cpu"), torch.randn((b, 10), generator=g),
                         pose[:, 1:], pose[:, 0])["vertices"]
    verts = aa_rotate_translate_points(verts, torch.tensor([1.0, 0.0, 0.0]), math.pi, torch.zeros(3))
    cam_t = torch.cat([0.05 * (2 * torch.rand((b, 2), generator=g) - 1), torch.full((b, 1), 2.5)], -1)
    sv = renderer._screen_verts(verts[:, renderer.dp["vertex_map"]], cam_t, torch.full((b, 2), 0.9))
    faces = renderer.dp["faces"]
    faces = faces[cuda_tiled.tile_sort_order(sv[0], faces)]
    f, chunk = faces.shape[0], cuda_tiled.FACE_CHUNK
    c = -(-f // chunk)
    consts = cuda_tiled.cull_constants(sv, faces, img)
    consts = torch.cat([consts, consts.new_zeros(b, c * chunk - f, 12)], 1).reshape(b, c, chunk, 12)
    ymin, ymax, xmin, xmax = cuda_tiled._chunk_bounds(sv[:, faces.long()], f)
    row0 = (torch.arange(img // cuda_tiled.BLOCK_ROWS) * cuda_tiled.BLOCK_ROWS).float()[:, None]
    col0 = (torch.arange(img // cuda_tiled.BLOCK_COLS) * cuda_tiled.BLOCK_COLS).float()[None, :]
    e = lambda t: t[..., None, None]  # noqa: E731
    live = ((e(ymax) >= row0) & (e(ymin) <= row0 + cuda_tiled.BLOCK_ROWS) & (e(xmax) >= col0)
            & (e(xmin) <= col0 + cuda_tiled.BLOCK_COLS))  # (B, C, tile rows, tile cols)
    mesh, ci, ti, tj = live.nonzero(as_tuple=True)
    sub_r = (torch.arange(cuda_tiled.BLOCK_ROWS // cuda_tiled.SUB_ROWS) * cuda_tiled.SUB_ROWS)[:, None]
    sub_c = (torch.arange(cuda_tiled.BLOCK_COLS // cuda_tiled.SUB_COLS) * cuda_tiled.SUB_COLS)[None, :]
    pairs = kept = 0
    for s0 in range(0, len(mesh), 256):
        q = consts[mesh[s0:s0 + 256], ci[s0:s0 + 256]]  # (n, 64, 12)
        r = (ti[s0:s0 + 256] * cuda_tiled.BLOCK_ROWS)[:, None, None, None] + sub_r
        cc = (tj[s0:s0 + 256] * cuda_tiled.BLOCK_COLS)[:, None, None, None] + sub_c
        cover = cuda_tiled.may_cover(q[:, :, None, None, :], r, cc)
        pairs += cover.numel()
        kept += int(cover.sum())
    # the bound's work (chip_smoke.py::_coverage_work): the pixels of each
    # valid face's widened, clipped box
    tri = sv[:, faces.long()]
    x, y = tri[..., 0], tri[..., 1]
    area = (x[..., 1] - x[..., 0]) * (y[..., 2] - y[..., 0]) - (x[..., 2] - x[..., 0]) * (y[..., 1] - y[..., 0])
    span = lambda t: (torch.clamp(torch.ceil(t.amax(-1)) + 1, max=img - 1)  # noqa: E731
                      - torch.clamp(torch.floor(t.amin(-1)) - 1, min=0) + 1).clamp(min=0).double()
    box_px = float(torch.where(area.abs() > 1e-9, span(x) * span(y), 0.0).sum())
    assert 1 - kept / pairs >= 0.9
    assert kept * cuda_tiled.SUB_ROWS * cuda_tiled.SUB_COLS <= 2 * box_px


def test_k2_forward_plan_covers_every_row_once_and_fills_the_card():
    """forward_plan's row group for every row count 1..4,096 at V = 6,890
    and 1,000: its grid covers each row and vertex exactly once (the last
    group ragged), stays within the launch's grid limit, and is the largest
    group whose grid gives each of the card's 132 SMs three blocks, else the
    smallest; at the optimise loop's 32 rows the grid has at least two
    blocks an SM, and predict's 3,200 rows take the largest group."""
    sms = 132
    for v in (6890, 1000):
        for b in range(1, 4097):
            plan = cuda_lbs.forward_plan(b, v, sms)
            rows, verts = cuda_lbs.FORWARD_PLANS[plan]
            grid = (-(-v // verts), -(-b // rows))
            assert grid[1] <= 65535
            assert (grid[1] - 1) * rows < b <= grid[1] * rows and (grid[0] - 1) * verts < v <= grid[0] * verts
            fits = [-(-v // pv) * -(-b // pr) >= 3 * sms for pr, pv in cuda_lbs.FORWARD_PLANS]
            assert plan == (fits.index(True) if any(fits) else len(fits) - 1)
    plan32 = cuda_lbs.forward_plan(32, 6890, sms)
    rows, verts = cuda_lbs.FORWARD_PLANS[plan32]
    assert -(-6890 // verts) * -(-32 // rows) >= 2 * sms
    assert cuda_lbs.forward_plan(3200, 6890, sms) == 0
    assert cuda_lbs.FORWARD_PLANS[0][0] == max(rows for rows, _ in cuda_lbs.FORWARD_PLANS)


def test_k4_tile_plan_fits_every_image_size():
    """For every image size K4 admits (1 to 32,768): the tile's keys fit the
    default budget (within the kernel's limit), its rows and columns tile
    the image with no empty tile, and the grid stays within the launch's
    limit at 72 meshes."""
    assert cuda_raster.TILE_KEYS <= cuda_raster.MAX_TILE_KEYS
    for size in range(1, 32769):
        rows, cols, row_tiles, col_tiles = cuda_raster.tile_plan(size)
        assert 1 <= rows <= size and 1 <= cols <= min(size, cuda_raster.TILE_COLS)
        assert rows * cols <= cuda_raster.TILE_KEYS
        assert (row_tiles - 1) * rows < size <= row_tiles * rows
        assert (col_tiles - 1) * cols < size <= col_tiles * cols
        assert 72 * row_tiles * col_tiles < 2**31


@pytest.mark.parametrize("size", [1, 33, 200, 256, 384, 1024, 32768])
def test_k4_tile_plan_covers_every_pixel_once(size):
    """Over the grid of 3 meshes, each mesh's pixel lies in exactly one
    block's tile, with the blocks mapped to tiles as the kernel maps them
    (cuda_raster.block_tile: row tiles from the middle outwards)."""
    meshes = 3
    rows, cols, row_tiles, col_tiles = cuda_raster.tile_plan(size)
    row_hits = np.zeros((meshes, size), np.int64)
    col_hits = np.zeros((meshes, size), np.int64)
    tiles = [cuda_raster.block_tile(b, meshes, row_tiles, col_tiles) for b in range(meshes * row_tiles * col_tiles)]
    assert len(set(tiles)) == len(tiles)
    for m, rt, ct in tiles:
        assert 0 <= m < meshes and 0 <= rt < row_tiles and 0 <= ct < col_tiles
        if ct == 0:
            row_hits[m, rt * rows:min(size, (rt + 1) * rows)] += 1
        if rt == 0:
            col_hits[m, ct * cols:min(size, (ct + 1) * cols)] += 1
    assert (row_hits == 1).all() and (col_hits == 1).all()
    if size <= 1024:
        hits = np.zeros((meshes, size, size), np.int64)
        for m, rt, ct in tiles:
            hits[m, rt * rows:(rt + 1) * rows, ct * cols:(ct + 1) * cols] += 1
        assert (hits == 1).all()
    if row_tiles > 2:  # the middle row tile comes first
        assert tiles[0][1] == (row_tiles - 1) // 2


def test_k4_tile_plan_fills_the_card_at_the_training_shape():
    """72 meshes at 256² (the training render) give at least one block per
    SM of the H100's 132, in 16-row tiles of whole rows (32 KB of keys)."""
    rows, cols, row_tiles, col_tiles = cuda_raster.tile_plan(256)
    assert (rows, cols) == (16, 256) and rows * cols * 8 == 32 * 1024
    assert 72 * row_tiles * col_tiles >= 132


@pytest.mark.parametrize("n", [1, 4, 7, 16, 17, 100, 101])
def test_k1_row_chunks_cover_every_row_once(n):
    """K1's chunks for 9 groups of n rows, as the kernel stages them
    (models/cuda_lbs.py::moments_blocks): every row of every group exactly
    once; each block's chunks are 16 rows, then at most one each of 8, 4, 2
    and 1 in that order, so no slot is empty; a group's block holds only
    that group's rows, and the groups' last n % 16 rows (when 1 to 4) go
    four groups to a chunk."""
    groups = 9
    hits = np.zeros((groups, n), np.int64)
    blocks = cuda_lbs.moments_blocks(groups, n)
    tail = cuda_lbs.moments_tail(n)
    assert len(blocks) == groups + (-(-groups // 4) if tail else 0)
    for y, chunks in enumerate(blocks):
        sizes = [len(c) for c in chunks]
        total = sum(sizes)
        assert sizes == [16] * (total // 16) + [r for r in (8, 4, 2, 1) if total % 16 & r], y
        for chunk in chunks:
            for group, row in chunk:
                hits[group, row] += 1
                assert group == y if y < groups else row >= n - tail
    assert (hits == 1).all()
    if n == 100:  # each group's own rows in six chunks of 16; the tails of four groups in one more
        blocks = cuda_lbs.moments_blocks(32, 100)
        assert [len(c) for c in blocks[0]] == [16] * 6 and [len(c) for c in blocks[32]] == [16]
        assert len(blocks) == 40 and sum(len(b) for b in blocks) == 200


def _k4_span_cases(img):
    """(verts_screen, faces) at img²: the near-degenerate faces of
    utils/profiling.py::sliver_case (both meshes), a posed body as the
    training render sees it and, at 128², the 600 faces of _cull_soup (on
    the pixel grid, huge, zero-area)."""
    from humaniflow_torch.models import synthetic_smpl
    from humaniflow_torch.utils.profiling import training_screen

    sv, faces = sliver_case(img, device="cpu")
    renderer, body = training_screen(synthetic_smpl(num_verts=6890, device="cpu"), 1, 8, device="cpu", img=img)
    cases = [(sv, faces.long()), (body, renderer.dp["faces"].long())]
    if img == 128:
        cases.append(_cull_soup(np.random.default_rng(4)))
    return cases


@pytest.mark.parametrize("img", [128, 256])
def test_k4_row_spans_never_drop_a_pixel_the_rounded_formula_finds_inside(img):
    """Every pixel centre of an img² image (128², and the training render's
    256²: the span's margin depends on the size), for every face of the
    cases: where the float32 per-pixel formula of K4 and its twin (w0, w1,
    w2 ≥ 0 from the edge-plane coefficients) puts the centre inside a face
    with finite coefficients, the pixel's column lies in the face's row
    span.  The slivers' rounding claims centres outside their boxes, so
    this is the formula's own rounding, not the geometry.  On the posed
    body the spans leave at most half of the box pixels to test."""
    cols = torch.arange(img)
    gx = (cols.to(torch.float32) + 0.5)[None, None, :]
    checked = inside_total = span_px = box_px = 0
    for verts, faces in _k4_span_cases(img):
        for f0 in range(0, faces.shape[0], 400):
            tri = verts[:, faces[f0:f0 + 400]]  # (M, n, 3, 3)
            coef = cuda_raster._edge_plane_coeffs(tri.reshape(tri.shape[:2] + (9,)))
            consts = cuda_raster.span_constants(coef, img)
            finite = torch.isfinite(coef[..., :6]).all(-1)[..., None]
            c = coef[..., None, :]
            a0x, a1x = c[..., 0] * gx, c[..., 3] * gx  # the same in every row: (M, n, W)
            for row in range(img):
                gy = torch.tensor(row + 0.5, dtype=torch.float32)
                w0 = (a0x + c[..., 1] * gy) + c[..., 2]
                w1 = (a1x + c[..., 4] * gy) + c[..., 5]
                inside = (torch.minimum(torch.minimum(w0, w1), (1.0 - w0) - w1) >= 0) & finite  # (M, n, W)
                lo, hi = cuda_raster.row_spans(coef, consts, torch.tensor(row))
                outside_span = (cols < lo[..., None]) | (cols > hi[..., None])
                assert not bool((inside & outside_span).any()), (f0, row)
                checked += inside.numel()
                inside_total += int(inside.sum())
        if faces.shape[0] > 10000:  # the posed body: spans against boxes
            tri = verts[:, faces]
            x, y = tri[..., 0], tri[..., 1]
            x_lo = (torch.floor(x.amin(-1)) - 1).clamp(min=0)
            x_hi = (torch.ceil(x.amax(-1)) + 1).clamp(max=img - 1)
            y_lo = (torch.floor(y.amin(-1)) - 1).clamp(min=0)
            y_hi = (torch.ceil(y.amax(-1)) + 1).clamp(max=img - 1)
            coef = cuda_raster._edge_plane_coeffs(tri.reshape(tri.shape[:2] + (9,)))
            consts = cuda_raster.span_constants(coef, img)
            area = (x[..., 1] - x[..., 0]) * (y[..., 2] - y[..., 0]) - (x[..., 2] - x[..., 0]) * (y[..., 1] - y[..., 0])
            kept = area > 1e-9
            for row in range(img):
                lo, hi = cuda_raster.row_spans(coef, consts, torch.tensor(row))
                rows_in = kept & (y_lo <= row) & (y_hi >= row) & (x_lo <= x_hi)
                a, b = torch.maximum(lo, x_lo.long()), torch.minimum(hi, x_hi.long())
                span_px += int(torch.where(rows_in, (b - a + 1).clamp(min=0), 0).sum())
                box_px += int(torch.where(rows_in, x_hi - x_lo + 1, 0).sum())
    assert checked > 10**8 and inside_total > 10**5
    assert 0 < span_px <= 0.5 * box_px
