"""The port's silhouette path against humaniflow_tpu on the CPU: edge-plane
coefficients, projections, the exact coverage scan, K3's plain twin and
the renderer.  K3 itself against its twin on a GPU:
tests/test_torch_kernels.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import t

from humaniflow_torch.models import smpl as tsmpl
from humaniflow_torch.ops import so3_exp
from humaniflow_torch.ops.camera import orthographic_project as t_ortho
from humaniflow_torch.render import TexturedIUVRenderer as TorchRenderer
from humaniflow_torch.render import cuda_coverage
from humaniflow_torch.render import rasterizer as traster
from humaniflow_torch.render.renderer import load_densepose_uv_host
from humaniflow_tpu.ops.camera import orthographic_project as j_ortho
from humaniflow_tpu.render import TexturedIUVRenderer as JaxRenderer
from humaniflow_tpu.render import rasterizer as jraster
from humaniflow_tpu.render.binned_rasterizer import _edge_plane_coeffs as j_coeffs

# Coefficients: 1e-6 relative to each coefficient row's largest magnitude
# (c0, c1 and zc cancel, so an element-wise rtol would be wrong).
# Projections: 1e-5 px.  Masks, pixels per mesh: exact scan vs exact scan
# ≤ 1 and K3's twin without culling ≤ 1 (an edge pixel whose test rounds
# differently in the two formulas); with back-face culling ≤ 8 (the
# DensePose seam hole: a pixel seen only through it keeps a back face).
COEF_RTOL = 1e-6
PROJ_ATOL = 1e-5
EXACT_PX = 1
CULL_PX = 8
IMG = 64
B = 4


def _posed_bodies(b=B, seed=1):
    """(vertices (b, 6890, 3), cam_wp (b, 3)): synthetic SMPL under random
    poses and shapes, from numpy seeds."""
    smpl = tsmpl.synthetic_smpl(num_verts=6890, device="cpu")
    rng = np.random.default_rng(seed)
    pose = so3_exp(t(rng.normal(scale=0.25, size=(b, 23, 3)).astype(np.float32)))
    shape = t(rng.normal(size=(b, 10)).astype(np.float32))
    verts = tsmpl.smpl_forward(smpl, shape, pose, torch.eye(3).expand(b, 3, 3))["vertices"]
    cam = np.tile(np.array([[0.9, 0.0, 0.2]], np.float32), (b, 1))
    cam[:, 0] += rng.uniform(-0.1, 0.1, size=b).astype(np.float32)
    return verts, t(cam)


@pytest.fixture(scope="module")
def screen():
    """DensePose-vertex screen coordinates (B, 7829, 3) at IMG² and the
    DensePose faces."""
    dp = load_densepose_uv_host()
    verts, cam = _posed_bodies()
    sv = traster.project_orthographic_screen(verts[:, torch.as_tensor(dp["vertex_map"], dtype=torch.long)], cam, IMG)
    return sv, dp["faces"]


@pytest.fixture(scope="module")
def jax_exact(screen):
    sv, faces = screen
    return np.asarray(jraster.rasterize_coverage(jnp.asarray(sv.numpy()), jnp.asarray(faces), IMG))


def _per_mesh_diff(got, want):
    return (np.asarray(got) != np.asarray(want)).reshape(len(want), -1).sum(1)


def test_edge_plane_coeffs_match_jax():
    rng = np.random.default_rng(0)
    tri = rng.uniform(0, 256, size=(500, 9)).astype(np.float32)
    tri[:, 2::3] = rng.uniform(2, 3, size=(500, 3))
    tri[:20, 6:8] = tri[:20, 0:2]  # v2 = v0: degenerate
    want = np.asarray(j_coeffs(jnp.asarray(tri)))
    got = cuda_coverage._edge_plane_coeffs(t(tri)).numpy()
    scale = np.abs(want).max(axis=0)
    assert float((np.abs(got - want) / scale).max()) <= COEF_RTOL
    np.testing.assert_array_equal(got[:20, 2], -1.0)


def test_projections_match_jax():
    rng = np.random.default_rng(2)
    pts = rng.normal(size=(3, 50, 3)).astype(np.float32)
    cam = np.concatenate([rng.uniform(0.5, 1.2, (3, 1)), rng.normal(scale=0.2, size=(3, 2))], 1).astype(np.float32)
    np.testing.assert_allclose(t_ortho(t(pts), t(cam)).numpy(), np.asarray(j_ortho(jnp.asarray(pts), jnp.asarray(cam))),
                               atol=PROJ_ATOL, rtol=0)
    np.testing.assert_allclose(
        traster.project_orthographic_screen(t(pts), t(cam), 256).numpy(),
        np.asarray(jraster.project_orthographic_screen(jnp.asarray(pts), jnp.asarray(cam), 256)),
        atol=PROJ_ATOL, rtol=0,
    )


def test_rasterize_coverage_matches_jax(screen, jax_exact):
    sv, faces = screen
    got = traster.rasterize_coverage(sv, t(faces), IMG)
    diff = _per_mesh_diff(got.numpy(), jax_exact)
    print(f"\nexact scan, port vs JAX: differing px per mesh {diff.tolist()} "
          f"(covered {jax_exact.reshape(B, -1).sum(1).tolist()})")
    assert jax_exact.any(axis=(1, 2)).all()
    assert diff.max() <= EXACT_PX


@pytest.mark.parametrize("cull_sign,bound", [(0, EXACT_PX), (1, CULL_PX)])
def test_coverage_plain_matches_jax_exact_scan(screen, jax_exact, cull_sign, bound):
    sv, faces = screen
    mask, overflow = cuda_coverage.coverage(sv, t(faces), IMG, cull_sign=cull_sign)  # CPU: the twin
    diff = _per_mesh_diff(mask.numpy(), jax_exact)
    print(f"\nK3 twin cull_sign={cull_sign} vs JAX exact scan: differing px per mesh {diff.tolist()}")
    assert mask.dtype == torch.bool and overflow.dtype == torch.int32
    assert overflow.tolist() == [0] * B
    assert diff.max() <= bound


def test_coverage_plain_drops_bad_faces_and_counts_them():
    """Faces with an index outside [0, V) are dropped and counted per mesh;
    degenerate and non-finite faces cover nothing; a face crossing the
    border is clipped."""
    verts = t(np.array([[[1, 1, 0], [14, 2, 0], [3, 13, 0], [5, 5, 0], [np.nan, 4, 0], [-6, 8, 0], [20, 9, 0]]],
                       np.float32)).repeat(2, 1, 1)
    faces = t(np.array([[0, 1, 2], [0, 3, 3], [0, 4, 1], [5, 6, 3], [0, 1, 7]], np.int32))
    mask, overflow = cuda_coverage.coverage_plain(verts, faces, 16)
    alone, _ = cuda_coverage.coverage_plain(verts, faces[:1], 16)
    border, _ = cuda_coverage.coverage_plain(verts, faces[3:4], 16)
    assert overflow.tolist() == [1, 1]
    assert torch.equal(mask, alone | border)
    assert border[0, :, 0].any() and border[0, :, 15].any()


def test_renderer_silhouettes_match_jax_renderer():
    verts, cam = _posed_bodies(b=3, seed=4)
    jr = JaxRenderer(img_wh=IMG, projection_type="orthographic", render_rgb=False)
    want_mask, want_ov = jr.render_silhouette_with_overflow(jnp.asarray(verts.numpy()), jnp.asarray(cam.numpy()))
    tr = TorchRenderer(img_wh=IMG, render_rgb=False, device="cpu")
    mask, overflow = tr.render_silhouette_with_overflow(verts, cam)
    assert mask.dtype == torch.float32 and mask.shape == (3, IMG, IMG)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(want_mask))
    np.testing.assert_array_equal(overflow.numpy(), np.asarray(want_ov))
    assert overflow.tolist() == [0, 0, 0]
    np.testing.assert_array_equal(tr.render_silhouette(verts, cam).numpy(), np.asarray(want_mask))
