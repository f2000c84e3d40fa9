"""K2's restructured backward, K3's band plan, K6's cull, K2's forward plan,
K4's tile plan, K1's row chunks, K5's row plan, weight pack, plan cache and
3xTF32 arithmetic, and K7's row and vertex tiling on the CPU.

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
sub-block; and on posed bodies it skips most (face, sub-block) pairs.  K5's
pack is read back through the mma fragment layout and its 3xTF32 split is
emulated from it against the twin.  The kernels themselves are held
against the twins on the card in tests/test_torch_kernels.py.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_cases import sliver_case
from _torch_parity import rel_err, t

import humaniflow_tpu.models.pallas_lbs as jlbs
from humaniflow_torch.models import cuda_lbs
from humaniflow_torch.render import cuda_coverage, cuda_raster, cuda_tiled
from humaniflow_torch.render.rasterizer import _barycentrics

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
    near-degenerate faces of _torch_cases.py::sliver_case on both its
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
    _torch_cases.py::sliver_case (both meshes), a posed body as the
    training render sees it and, at 128², the 600 faces of _cull_soup (on
    the pixel grid, huge, zero-area)."""
    from humaniflow_torch.models import synthetic_smpl
    from _torch_cases import training_screen

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


# ---- K5 (flows/cuda_level.py): row plan, weight pack, plan cache, 3xTF32


def _k5_flow(c_dim=64, hidden=(64, 32, 32), seed=0):
    from humaniflow_torch.flows.factory import create_conditional_norm_flow

    flow = create_conditional_norm_flow(event_dim=3, context_dim=c_dim, num_transforms=2, num_parts=23,
                                        transform_hidden_dims=hidden, radial_tanh_radius=1.5 * math.pi)
    g = torch.Generator().manual_seed(seed)
    for m in flow.transforms:
        if hasattr(m, "hypernet"):
            m.hypernet.reset_parameters(g)
    return flow


def _k5_column_of_output(o, n_out, last):
    """The packed accumulator column holding output feature o of a layer:
    hidden layers in order; the last layer's w, h, d, l blocks at columns
    0, 16, 32, 48, dimension j 8 columns further, d's 7 bins padded to 8."""
    if not last:
        return o
    for first, bins, col in ((0, 8, 0), (16, 8, 16), (32, 7, 32), (46, 8, 48)):
        if first <= o < first + 2 * bins:
            return col + 8 * ((o - first) // bins) + (o - first) % bins
    raise AssertionError(o)


def _k5_logical_k(i, layer, c_dim, prev_col):
    """The logical k (8·k-step + k) that input feature i takes in a layer:
    the first layer's context feature 16q + 4t + 2h + s sits at k-step 2q +
    h, k = t + 4s (a lane's float4); a later layer's input is the previous
    accumulator's column 8·ks + 2t + s, at k-step ks, k = t + 4s."""
    if layer == 0:
        q, rem = divmod(i, 16)
        t, h, s = rem // 4, rem % 4 // 2, rem % 2
        return 8 * (2 * q + h) + t + 4 * s
    col = prev_col(i)
    ks, t, s = col // 8, col % 8 // 2, col % 2
    return 8 * ks + t + 4 * s


def _k5_decode_b(frag, nks, nnt):
    """(P, 8·nks, 8·nnt) B matrices from mma B fragments [ks][n-tile pair]
    [lane][4]: lane 4g + t holds B[t][g] and B[t + 4][g] of n-tile 2·pair,
    then of n-tile 2·pair + 1 (the m16n8k8 .col B layout)."""
    p = frag.shape[0]
    f = frag.reshape(p, nks, nnt // 2, 32, 4)
    b = torch.zeros((p, nks, 8, nnt, 8), dtype=frag.dtype)
    lane = torch.arange(32)
    g, t = lane // 4, lane % 4
    for pair in range(nnt // 2):
        for e in range(4):
            b[:, :, t + 4 * (e % 2), 2 * pair + e // 2, g] = f[:, :, pair, :, e]
    return b.reshape(p, 8 * nks, 8 * nnt)


def _k5_layers(pack_c, prm, c):
    """Per layer of coupling c: (B, bias by column, x0's column or None)."""
    out = []
    for li in range(prm.n_layers[c]):
        off, nks, nnt = prm.layer_off[c][li], prm.k_steps[c][li], prm.n_tiles[c][li]
        blk = pack_c[:, off:off + prm.layer_floats[c][li]]
        nb = nks * nnt * 64
        x0col = blk[:, nb + 8 * nnt:nb + 16 * nnt] if li == 0 else None
        out.append((_k5_decode_b(blk[:, :nb], nks, nnt), blk[:, nb:nb + 8 * nnt], x0col))
    return out


@pytest.mark.parametrize("c_dim,hidden", [(64, (64, 32, 32)), (8, (40, 24)), (37, (128, 64))],
                         ids=["default", "narrow", "wide"])
def test_k5_pack_unpacks_to_the_hypernet(c_dim, hidden):
    """level_pack, read back through the mma fragment layout and the
    column and k orders the kernel uses (plain inverses written here), gives
    every hypernet weight and bias of every part and coupling; every other
    float of the pack is zero."""
    from humaniflow_torch.flows import cuda_level

    flow = _k5_flow(c_dim, hidden)
    prm = cuda_level.level_params(flow, c_dim, torch.device("cpu"))
    pack = cuda_level.level_pack(flow, c_dim)
    blocks, _ = cuda_level._plan(flow)
    assert pack.shape == (23, len(blocks), prm.coupling_floats)
    assert prm.max_tiles == (16 if max(hidden) > 64 else 8)
    for c, (_, coupling) in enumerate(blocks):
        ws, bs = coupling.hypernet.weights, coupling.hypernet.biases
        layers = _k5_layers(pack[:, c], prm, c)
        used = 0
        for li, ((bmat, bias, x0col), w, b) in enumerate(zip(layers, ws, bs)):
            n_out, n_in = w.shape[1:]
            last = li == len(ws) - 1
            cols = [_k5_column_of_output(o, n_out, last) for o in range(n_out)]
            ks = [_k5_logical_k(i, li, c_dim, lambda i: i) for i in range(n_in - (1 if li == 0 else 0))]
            got = bmat[:, ks][:, :, cols].transpose(1, 2)
            if li == 0:
                got = torch.cat([got, x0col[:, cols, None]], -1)
                used += int((x0col != 0).sum())
            assert torch.equal(got, w.detach()), (c, li)
            assert torch.equal(bias[:, cols], b.detach()), (c, li)
            used += int((bmat != 0).sum()) + int((bias != 0).sum())
        assert used == int((pack[:, c] != 0).sum())  # nothing else in the pack is non-zero


def test_k5_plan_cache_repacks_after_an_in_place_load():
    """The plan cache keys each hypernet tensor on its address, shape and
    version: load_state_dict copies new weights into the same storage, and
    the next call repacks them; a call with nothing changed reuses the
    pack."""
    from humaniflow_torch.flows import cuda_level

    cpu = torch.device("cpu")
    flow = _k5_flow(seed=1)
    prm = cuda_level._cached_plan(flow, 64, cpu)
    _, _, pack = cuda_level._PLANS[flow][(64, cpu)]
    assert prm.packed == pack.data_ptr() and cuda_level._cached_plan(flow, 64, cpu) is prm
    ptrs = [t.data_ptr() for t in flow.parameters()]
    flow.load_state_dict(_k5_flow(seed=2).state_dict())
    assert [t.data_ptr() for t in flow.parameters()] == ptrs  # in place: the address alone would not see it
    prm2 = cuda_level._cached_plan(flow, 64, cpu)
    _, _, pack2 = cuda_level._PLANS[flow][(64, cpu)]
    assert prm2 is not prm and prm2.packed == pack2.data_ptr()
    assert torch.equal(pack2, cuda_level.level_pack(flow, 64)) and not torch.equal(pack2, pack)


def _tf32(x):
    """Round float32 to TF32 (10 explicit mantissa bits), nearest, ties away
    from zero: cvt.rna.tf32.f32."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _tf32_truncated(x):
    """float32 cut to TF32 toward zero: a float32 operand as the tensor core
    reads it at worst (its lower 13 bits dropped)."""
    return (x.view(torch.int32) & -0x2000).view(torch.float32)


def _mm_tf32(a, b, terms):
    """a (..., P, K) @ b (P, K, N) on TF32 tensor cores, float32 sums: a =
    a_hi + a_lo, b = b_hi + b_lo with hi rounded to TF32 and lo = a - hi,
    read truncated to TF32.  terms 3: a_lo b_hi + a_hi b_lo + a_hi b_hi, as
    K5 computes it; 2: without a_lo b_hi; 1: a_hi b_hi alone (single-pass
    TF32)."""
    a_hi, b_hi = _tf32(a), _tf32(b)
    a_lo, b_lo = _tf32_truncated(a - a_hi), _tf32_truncated(b - b_hi)
    mm = lambda x, y: torch.einsum("...pk,pkn->...pn", x, y)  # noqa: E731
    out = mm(a_hi, b_hi)
    if terms >= 2:
        out = mm(a_hi, b_lo) + out
    if terms >= 3:
        out = mm(a_lo, b_hi) + out
    return out


def _k5_emulate(flow, z, ctx, parts, terms=3):
    """K5's arithmetic in plain torch: the MLP from the pack in TF32 with
    `terms` terms of the split (_mm_tf32; K5 takes 3) and the kernel's k
    and column orders, x0 by a float32 product, then the port's splines and
    radial tanh on the packed parameter columns."""
    from humaniflow_torch.flows import cuda_level
    from humaniflow_torch.flows.spline import monotonic_rational_spline_forward

    c_dim = ctx.shape[-1]
    prm = cuda_level.level_params(flow, c_dim, torch.device("cpu"))
    pack = cuda_level.level_pack(flow, c_dim)[parts]
    blocks, radius = cuda_level._plan(flow)
    x = z
    for c, (perm, coupling) in enumerate(blocks):
        x = x[..., list(perm)]
        layers = _k5_layers(pack[:, c], prm, c)
        for li, (bmat, bias, x0col) in enumerate(layers):
            if li == 0:
                feat = torch.tensor([16 * (ks // 2) + 4 * (k % 4) + 2 * (ks % 2) + k // 4
                                     for ks in range(bmat.shape[1] // 8) for k in range(8)])
                a = torch.where(feat < c_dim, ctx[..., feat.clamp(max=c_dim - 1)], 0.0)
                h = bias + _mm_tf32(a, bmat, terms) + x[..., :1] * x0col
            else:
                cols = torch.tensor([8 * ks + 2 * (k % 4) + k // 4 for ks in range(bmat.shape[1] // 8)
                                     for k in range(8)])
                h = bias + _mm_tf32(torch.relu(h)[..., cols], bmat, terms)
        par = h.reshape(h.shape[:-1] + (4, 2, 8))  # (kind, dimension, bin) by packed column
        y = monotonic_rational_spline_forward(x[..., 1:], par[..., 0, :, :], par[..., 1, :, :], par[..., 2, :, :7],
                                              par[..., 3, :, :], bound=coupling.bound)
        x = torch.cat([x[..., :1], y], -1)
    return flow.transforms[-1](x) if radius is not None else x


@torch.no_grad()
def test_k5_3xtf32_emulation_matches_the_twin_on_every_level():
    """K5's MLP in 3xTF32, emulated from the pack with the kernel's k and
    column orders, against the twin (the eager float32 flow) within K5's
    2e-5 on all 8 levels of the default model at its seeded weights: its
    own contexts and noise from a forward (hooked on the flow), and
    0.6·N(0, 1), zero and ±10 base samples on the same contexts.  The
    limit would catch less: the split without a_lo·b_hi, and single-pass
    TF32, each miss 2e-5 on some level."""
    from humaniflow_torch.configs import get_humaniflow_cfg_defaults
    from humaniflow_torch.models import HumaniflowModel

    model = HumaniflowModel(get_humaniflow_cfg_defaults().MODEL, device="cpu",
                            generator=torch.Generator().manual_seed(0))
    captured = []
    handle = model.flow.register_forward_hook(lambda m, args, out: captured.append(args))
    try:
        proxy = torch.rand((3, 64, 64, 18), generator=torch.Generator().manual_seed(1))
        model.apply(proxy, generator=torch.Generator().manual_seed(2), num_samples=20)
    finally:
        handle.remove()
    assert len(captured) == len(model.levels)
    rng = np.random.default_rng(3)
    worst = {terms: [] for terms in (3, 2, 1)}  # per level
    for z_model, ctx, parts in captured:
        z_model, ctx = z_model.reshape(-1, *z_model.shape[-2:]), ctx.reshape(-1, *ctx.shape[-2:])
        normal = torch.from_numpy((0.6 * rng.normal(size=z_model.shape)).astype(np.float32))
        tails = torch.full_like(normal, 10.0)
        tails[::2] = -10.0
        cases = [(z, model.flow(z, ctx, parts)) for z in (z_model, normal, torch.zeros_like(normal), tails)]
        for terms, errs in worst.items():
            errs.append(max(float((_k5_emulate(model.flow, z, ctx, parts, terms) - want).abs().max())
                            for z, want in cases))
        assert worst[3][-1] <= 2e-5, (tuple(parts.tolist()), worst[3][-1])
    assert max(worst[3]) > 0  # the emulation rounds: it is not the twin itself
    assert max(worst[2]) > 2e-5 and max(worst[1]) > 2e-5, worst
