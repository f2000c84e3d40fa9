"""The port's visualisation path against humaniflow_tpu on the CPU: the uncrop,
the renderer's tiled branch (K6's twin) against JAX's tiled branch, the
twin against JAX's exact scan, the point-estimate and sample figures, the
colour map and views, the J2D-error-sorted sampling, and the predict CLI's
visualisation flags.  K6 itself against its twin on the card:
tests/test_torch_kernels.py.

JAX's tiled rasterizer (`rasterize_pallas`, a Pallas TPU kernel) has no CPU
mode, so JAX's tiled branch runs here with its Pallas call stood in by its
exact scan `rasterize` on the same sorted faces.  The renders read a
DensePose table cut to every FACE_STRIDE-th face (the full table's 13,774
faces make the CPU's exact scans take minutes at 128²)."""

import math
import importlib
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import t

import humaniflow_tpu.render.pallas_rasterizer as jpallas
from humaniflow_torch.data import image_ops as tops
from humaniflow_torch.models import smpl as tsmpl
from humaniflow_torch.ops import aa_rotate_translate_points, so3_exp
from humaniflow_torch.render import TexturedIUVRenderer as TorchRenderer
from humaniflow_torch.render import cuda_tiled
from humaniflow_torch.utils import sampling as tsampling
from humaniflow_torch.utils import visualise as tvis
from humaniflow_tpu.data import image_ops as jops
from humaniflow_tpu.render import TexturedIUVRenderer as JaxRenderer
from humaniflow_tpu.render import rasterizer as jraster
from humaniflow_tpu.utils import sampling as jsampling
from humaniflow_tpu.utils import visualise as jvis

# Uncrop: 1e-5 (float32 resampling matmuls in other orders).  The tiled
# branch: face order, part ids and silhouettes equal on every pixel; UV
# within 2e-6 and depth within 1e-5 relative (XLA's CPU compiler contracts
# the edge functions and barycentric sums into FMAs: a few float32 ulps,
# more at a pixel centre next to the edge of a thin face), RGB within 1e-5.
# The twin against JAX's exact scan: mask and face ids equal, depth 1e-6
# relative.  Figures: 5e-5 (the same rounding through the lighting; a few
# values of ~6e5 differ by 1.4e-5).  Colour map and views: 1e-6.
UNCROP_ATOL, UV_ATOL, DEPTH_RTOL, RGB_ATOL, TWIN_DEPTH_RTOL = 1e-5, 2e-6, 1e-5, 1e-5, 1e-6
FIG_ATOL, VIEW_ATOL = 5e-5, 1e-6
IMG, B = 128, 2
FACE_STRIDE = 12


@pytest.fixture(scope="module")
def uv_mat(tmp_path_factory):
    """A DensePose UV table with every FACE_STRIDE-th face of the repo's."""
    from scipy.io import loadmat, savemat

    from humaniflow_torch.configs import paths

    m = loadmat(paths.DENSEPOSE_UV)
    keep = {k: m[k] for k in ("All_vertices", "All_U_norm", "All_V_norm")}
    keep.update(All_Faces=m["All_Faces"][::FACE_STRIDE], All_FaceIndices=m["All_FaceIndices"][::FACE_STRIDE])
    path = str(tmp_path_factory.mktemp("uv") / "UV_cut.mat")
    savemat(path, keep)
    return path


@pytest.fixture(scope="module")
def bodies():
    """(flipped vertices (B, 6890, 3), cam_wp (B, 3), T-pose vertices,
    per-vertex colours (B, 6890, 3)): synthetic SMPL under random poses and
    shapes, from numpy seeds."""
    smpl = tsmpl.synthetic_smpl(num_verts=6890, device="cpu")
    rng = np.random.default_rng(2)
    pose = so3_exp(t(rng.normal(scale=0.3, size=(B, 23, 3)).astype(np.float32)))
    shape = t(rng.normal(size=(B, 10)).astype(np.float32))
    glob = so3_exp(t(rng.normal(scale=0.3, size=(B, 3)).astype(np.float32)))
    x_axis = torch.tensor([1.0, 0.0, 0.0])
    flip = lambda v: aa_rotate_translate_points(v, x_axis, math.pi, torch.zeros(3))  # noqa: E731
    verts = flip(tsmpl.smpl_forward(smpl, shape, pose, glob)["vertices"])
    eye = torch.eye(3)
    tpose = flip(tsmpl.smpl_forward(smpl, shape, eye.expand(B, 23, 3, 3), eye.expand(B, 3, 3))["vertices"])
    cam = np.array([[0.9, 0.03, 0.05], [0.8, -0.05, 0.1]], np.float32)
    colours = np.stack([tvis.uncertainty_colourmap(rng.uniform(0, 0.25, 6890)) for _ in range(B)]).astype(np.float32)
    return verts.numpy(), cam, tpose.numpy(), colours


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
def test_batch_uncrop_affine_matches_jax(mode):
    rng = np.random.default_rng(3)
    crops = rng.uniform(size=(2, 40, 40, 3)).astype(np.float32)
    centres = np.array([[70.0, 45.0], [30.5, 80.25]], np.float32)
    h = np.array([60.0, 37.5], np.float32)
    w = np.array([55.0, 48.0], np.float32)
    args = ((90, 110), centres, h, w, (40, 40))
    want = jops.batch_uncrop_affine(jnp.asarray(crops), *(jnp.asarray(a) if isinstance(a, np.ndarray) else a
                                                          for a in args), mode=mode)
    got = tops.batch_uncrop_affine(t(crops), *(t(a) if isinstance(a, np.ndarray) else a for a in args), mode=mode)
    assert got.shape == (2, 110, 90, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=UNCROP_ATOL)


def test_tiled_branch_matches_jax_tiled_branch(bodies, uv_mat, monkeypatch):
    """Both renderers forced onto their tiled branch on the CPU, each
    rasterizer call recorded: the sorted face order, and IUV, depth,
    silhouettes and RGB on every pixel."""
    from humaniflow_torch.render import renderer as trenderer

    faces_seen = {}

    def jax_standin(sv, faces, image_size):
        faces_seen["jax"] = np.asarray(faces)
        return jraster.rasterize(sv, faces, image_size, chunk=2048)

    def port_tiled(sv, faces, image_size):
        faces_seen["port"] = faces.numpy()
        return cuda_tiled.rasterize_tiled(sv, faces, image_size)

    monkeypatch.setattr(jpallas, "rasterize_pallas", jax_standin)
    monkeypatch.setattr(trenderer, "rasterize_tiled", port_tiled)
    verts, cam, _, colours = bodies
    jr, tr = JaxRenderer(img_wh=IMG, uv_mat_path=uv_mat), TorchRenderer(img_wh=IMG, uv_mat_path=uv_mat, device="cpu")
    jr.rasterizer = tr.rasterizer = "tiled"
    cam_t = np.stack([cam[:, 1], cam[:, 2], np.full(B, 2.5, np.float32)], axis=-1)
    scale = cam[:, [0, 0]]
    # JAX's unjitted render, so that the stand-in sees concrete faces
    want = jr._render(jnp.asarray(verts), jnp.asarray(cam_t), jnp.asarray(scale), None, None, jnp.asarray(colours))
    got = tr(t(verts), cam_t=t(cam_t), orthographic_scale=t(scale), verts_features=t(colours))
    np.testing.assert_array_equal(faces_seen["port"], faces_seen["jax"])
    assert not np.array_equal(faces_seen["port"], tr.dp["faces"].numpy())  # the order did change
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["silhouettes"].numpy(), np.asarray(want["silhouettes"]))
    iuv, want_iuv = got["iuv_images"].numpy(), np.asarray(want["iuv_images"])
    np.testing.assert_array_equal(iuv[..., 0], want_iuv[..., 0])  # part ids: the same winners
    np.testing.assert_allclose(iuv[..., 1:], want_iuv[..., 1:], rtol=0, atol=UV_ATOL)
    np.testing.assert_allclose(got["depth_images"].numpy(), np.asarray(want["depth_images"]), rtol=DEPTH_RTOL,
                               atol=0)
    np.testing.assert_allclose(got["rgb_images"].numpy(), np.asarray(want["rgb_images"]), rtol=0, atol=RGB_ATOL)
    assert float(got["silhouettes"].mean()) > 0.02


def test_tiled_twin_matches_jax_exact_scan():
    """The inputs of tests/test_pallas_rasterizer.py (random faces over a
    256² image, sorted by centroid row)."""
    rng = np.random.default_rng(0)
    nv, nf, img, b = 500, 1000, 256, 2
    verts = rng.uniform(20, 230, size=(b, nv, 3)).astype(np.float32)
    verts[..., 2] = rng.uniform(1, 3, size=(b, nv)).astype(np.float32)
    base = rng.integers(0, nv - 3, size=(nf,))
    faces = np.stack([base, base + 1, base + 2], -1).astype(np.int32)
    sorted_faces = cuda_tiled.sort_faces_by_row(verts[0], faces)
    np.testing.assert_array_equal(sorted_faces, jpallas.sort_faces_by_row(verts[0], faces))
    ref = jraster.rasterize(jnp.asarray(verts), jnp.asarray(sorted_faces), img, chunk=512)
    out = cuda_tiled.rasterize_tiled(t(verts), t(sorted_faces), img)  # on the CPU: the twin
    np.testing.assert_array_equal(out.mask.numpy(), np.asarray(ref.mask))
    both = np.asarray(ref.mask)
    np.testing.assert_array_equal(out.face_idx.numpy()[both], np.asarray(ref.face_idx)[both])
    np.testing.assert_allclose(out.depth.numpy()[both], np.asarray(ref.depth)[both], rtol=TWIN_DEPTH_RTOL, atol=0)
    with pytest.raises(ValueError, match="multiple of 128"):
        cuda_tiled.rasterize_tiled(t(verts), t(sorted_faces), 200)


def test_tiled_twin_contract():
    """Ties go to the lowest index; a NaN depth never wins; a chunk holding
    a NaN coordinate is culled for every tile, as jnp.min makes the TPU
    kernel cull it; culling is by 32×128 tile."""
    v = torch.tensor([[[10.0, 10.0, 1.0], [60.0, 10.0, 1.0], [10.0, 60.0, 1.0],
                       [10.0, 10.0, math.nan], [60.0, 10.0, 2.0], [10.0, 60.0, 2.0],
                       [200.0, 100.0, 0.5], [230.0, 100.0, 0.5], [200.0, 120.0, 0.5]]])
    faces = torch.tensor([[3, 4, 5], [0, 1, 2], [0, 1, 2], [6, 7, 8]], dtype=torch.int32)
    fr = cuda_tiled.rasterize_tiled_plain(v, faces, 256)
    assert int(fr.face_idx[0, 20, 20]) == 1  # NaN depth lost; of the tie, the lower index
    assert int(fr.face_idx[0, 105, 205]) == 3
    assert float(fr.depth[0, 20, 20]) == 1.0 and torch.allclose(fr.bary[0, 20, 20].sum(), torch.tensor(1.0))
    assert int(fr.face_idx[0, 200, 200]) == -1 and float(fr.depth[0, 200, 200]) == 1e9
    v_nan = v.clone()
    v_nan[0, 3, 0] = math.nan  # a NaN x: the chunk's bounds turn NaN
    assert not bool(cuda_tiled.rasterize_tiled_plain(v_nan, faces, 256).mask.any())


def test_point_estimate_and_sample_figures_match_jax(bodies, uv_mat):
    verts, cam, tpose, colours = bodies
    rng = np.random.default_rng(4)
    image = rng.uniform(size=(B, IMG, IMG, 3)).astype(np.float32)
    jr, tr = JaxRenderer(img_wh=IMG, uv_mat_path=uv_mat), TorchRenderer(img_wh=IMG, uv_mat_path=uv_mat, device="cpu")
    want = jvis.render_point_est_visualisation(jr, jnp.asarray(verts), jnp.asarray(cam), input_image=image,
                                               tpose_vertices=jnp.asarray(tpose), vertex_colours=colours)
    figs = tvis.render_point_est_visualisation(tr, t(verts), t(cam), input_image=image, tpose_vertices=t(tpose),
                                               vertex_colours=colours)
    assert figs["figure"].shape == (B, IMG, 6 * IMG, 3) and set(figs["renders"]) == set(want["renders"])
    np.testing.assert_allclose(figs["figure"], want["figure"], rtol=0, atol=FIG_ATOL)

    # two samples: JAX reuses the compiled render of the views (same shapes)
    samples = tpose[::-1].copy()
    want = jvis.render_samples_visualisation(jr, jnp.asarray(samples), cam[:1], num_rows=1, num_cols=3)
    got = tvis.render_samples_visualisation(tr, t(samples), t(cam[:1]), num_rows=1, num_cols=3)
    assert got.shape == (IMG, 3 * IMG, 3) and not got[:, 2 * IMG:].any()
    np.testing.assert_allclose(got, want, rtol=0, atol=FIG_ATOL)

    orig = rng.uniform(size=(1, 150, 120, 3)).astype(np.float32)
    r0 = figs["renders"]["0"][:1]
    sil0 = (r0.sum(-1) > 0).astype(np.float32)
    box = (np.array([[80.0, 60.0]], np.float32), np.array([90.0], np.float32), orig)
    got_u = tvis.uncrop_point_est_visualisation(r0, sil0, *box)
    want_u = jvis.uncrop_point_est_visualisation(r0, sil0, *box)
    np.testing.assert_allclose(got_u, np.asarray(want_u), rtol=0, atol=UNCROP_ATOL)
    assert (got_u != orig).any()


def test_colourmap_and_views_match_jax(bodies):
    values = np.random.default_rng(5).uniform(-0.05, 0.3, size=500).astype(np.float32)
    np.testing.assert_allclose(tvis.uncertainty_colourmap(values), jvis.uncertainty_colourmap(values), rtol=0,
                               atol=VIEW_ATOL)
    verts = bodies[0]
    got, want = tvis.rotated_vertex_views(t(verts)), jvis.rotated_vertex_views(jnp.asarray(verts))
    assert list(got) == list(want) == ["0", "90", "180", "270"]
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=VIEW_ATOL, err_msg=k)
    img = np.full((8, 8, 3), 0.25, np.float32)
    assert tvis.annotate_joints2d(img, np.array([[2.0, 3.0]]), np.array([0.9])).shape == img.shape


def test_joints2d_error_sorted_sampling_matches_jax():
    """N = 20 samples; two joints invisible; two samples tied (duplicates)."""
    rng = np.random.default_rng(6)
    n, wh = 20, 32
    verts = rng.normal(size=(n, 50, 3)).astype(np.float32)
    joints = rng.normal(scale=0.4, size=(n, 90, 3)).astype(np.float32)
    joints[7] = joints[3]
    heat = np.zeros((1, 17, wh, wh), np.float32)
    for j in range(17):
        if j not in (4, 11):
            heat[0, j, rng.integers(wh), rng.integers(wh)] = 1.0
    cam = np.array([[0.8, 0.05, -0.02]], np.float32)
    want = jsampling.joints2d_error_sorted_verts_sampling(jnp.asarray(verts), jnp.asarray(joints), jnp.asarray(heat),
                                                          jnp.asarray(cam))
    got = tsampling.joints2d_error_sorted_verts_sampling(t(verts), t(joints), t(heat), t(cam))
    order = [int(np.flatnonzero((verts == g).all(axis=(1, 2)))[0]) for g in got.numpy()]
    want_order = [int(np.flatnonzero((verts == g).all(axis=(1, 2)))[0]) for g in np.asarray(want)]
    assert order == want_order and sorted(order) == list(range(n))


def test_predict_cli_writes_visualisations(tmp_path, monkeypatch):
    """`python -m humaniflow_torch.cli.run_predict -V -VS -VU` on two small
    PNGs on the CPU with seeded random weights and synthetic SMPL: the
    predictions and every visualisation PNG."""
    cv2 = pytest.importorskip("cv2")
    import humaniflow_torch.models as TM
    from humaniflow_torch.cli import run_predict
    tph = importlib.import_module("humaniflow_torch.pipelines.predict_hrnet")  # the module, not the function

    monkeypatch.setattr(tph, "HRNET_INPUT_WH", (64, 96))
    monkeypatch.setattr(tph, "HRNET_HEATMAP_WH", (16, 24))
    monkeypatch.setattr(TM, "load_smpl_npz", lambda *a, **k: tsmpl.synthetic_smpl(num_verts=6890, device=k["device"]))
    img_dir, out_dir = tmp_path / "images", tmp_path / "out"
    img_dir.mkdir()
    rng = np.random.default_rng(7)
    for name, (h, w) in (("a.png", (48, 40)), ("b.png", (36, 52))):
        cv2.imwrite(str(img_dir / name), rng.integers(0, 255, size=(h, w, 3)).astype(np.uint8))
    cfg = tmp_path / "small.yaml"
    cfg.write_text("DATA:\n  PROXY_REP_SIZE: 32\n")
    run_predict.main(["-I", str(img_dir), "-S", str(out_dir), "--hrnet_dtype", "f32", "-N", "3", "--cfg", str(cfg),
                      "-V", "-VS", "-VU", "-NV", "3", "--device", "cpu"])
    written = sorted(os.listdir(out_dir))
    for stem in ("a", "b"):
        for suffix in ("_pred.npz", "_vis.png", "_samples.png", "_uncrop.png", "_xyz_variance.png"):
            assert stem + suffix in written, (stem + suffix, written)
    vis = cv2.imread(str(out_dir / "a_vis.png"))
    assert vis.shape == (32, 6 * 32, 3)  # input crop, four views, T-pose
    assert cv2.imread(str(out_dir / "a_samples.png")).shape == (32, 3 * 32, 3)
    assert cv2.imread(str(out_dir / "b_uncrop.png")).shape == (36, 52, 3)
