"""The port's training render against humaniflow_tpu on the CPU: the exact
z-buffer scan, K4's plain twin, the exact textured render and the attribute
-rasterizer render.  K4 itself against its twin on a GPU:
tests/test_torch_kernels.py.

JAX's attribute rasterizer (`rasterize_binned_with_attrs`, a Pallas TPU
kernel) has no CPU mode, so the JAX side of the attribute-rasterizer render
runs with a stand-in built from its exact scan: planes are the winning
face's constants and its barycentrically interpolated linear attributes,
and (za, zb) its edge-plane depth gradients.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import t

import humaniflow_tpu.render.binned_rasterizer as jbinned
from humaniflow_torch.models import smpl as tsmpl
from humaniflow_torch.ops import aa_rotate_translate_points, so3_exp
from humaniflow_torch.render import TexturedIUVRenderer as TorchRenderer
from humaniflow_torch.render import cuda_raster
from humaniflow_torch.render import rasterizer as traster
from humaniflow_tpu.ops.rotation import aa_rotate_translate_points as j_rotate_translate
from humaniflow_tpu.render import TexturedIUVRenderer as JaxRenderer
from humaniflow_tpu.render import rasterizer as jraster

# Masks must agree on every pixel.  Winners (face ids) on ≥ 99.9% of the
# covered pixels: the exact scan's barycentric test and K4's edge-plane test
# round differently on a pixel centre that lies on an edge, and such a pixel
# can change hands.  Images: 1e-5 absolute on ≥ 99.9% of the pixel values
# (the pixels whose winners differ carry another face's values).
WINNER_FRAC = 0.999
IMG_ATOL = 1e-5
IMG = 64
B = 3
FOCAL = 300.0 * IMG / 256.0


@pytest.fixture(scope="module")
def bodies():
    """(vertices (B, 6890, 3) flipped as the training renders them, cam_t
    (B, 3), textures (B, 1200, 800, 3), lights): synthetic SMPL under random
    poses and shapes, all from numpy seeds."""
    smpl = tsmpl.synthetic_smpl(num_verts=6890, device="cpu")
    rng = np.random.default_rng(1)
    pose = so3_exp(t(rng.normal(scale=0.3, size=(B, 23, 3)).astype(np.float32)))
    shape = t(rng.normal(scale=1.25, size=(B, 10)).astype(np.float32))
    glob = so3_exp(t(rng.normal(scale=0.3, size=(B, 3)).astype(np.float32)))
    verts = tsmpl.smpl_forward(smpl, shape, pose, glob)["vertices"]
    verts = aa_rotate_translate_points(verts, torch.tensor([1.0, 0.0, 0.0]), math.pi, torch.zeros(3))
    cam_t = np.array([[0.0, -0.2, 2.5]] * B, np.float32) + rng.normal(scale=0.05, size=(B, 3)).astype(np.float32)
    textures = rng.uniform(size=(B, 1200, 800, 3)).astype(np.float32)
    lights = {
        "ambient_color": np.full((1, 3), 0.6, np.float32), "diffuse_color": np.full((1, 3), 0.5, np.float32),
        "specular_color": np.full((1, 3), 0.2, np.float32), "location": np.array([[0.8, -1.1, -0.4]], np.float32),
    }
    return verts.numpy(), cam_t, textures, lights


@pytest.fixture(scope="module")
def screen(bodies):
    verts, cam_t, _, _ = bodies
    dp = TorchRenderer(img_wh=IMG, device="cpu").dp
    sv = traster.project_perspective_screen(t(verts)[:, dp["vertex_map"]], t(cam_t), FOCAL, IMG)
    return sv, dp["faces"]


@pytest.fixture(scope="module")
def jax_frags(screen):
    sv, faces = screen
    return jraster.rasterize(jnp.asarray(sv.numpy()), jnp.asarray(faces.numpy()), IMG, chunk=4096)


def _winner_agreement(face_got, face_want):
    face_got, face_want = np.asarray(face_got), np.asarray(face_want)
    np.testing.assert_array_equal(face_got >= 0, face_want >= 0)
    covered = face_want >= 0
    frac = float((face_got[covered] == face_want[covered]).mean())
    assert covered.any(axis=(1, 2)).all()
    return frac


def test_projections_and_point_rotation_match_jax(bodies):
    from humaniflow_torch.ops.camera import perspective_project as t_persp
    from humaniflow_tpu.ops.camera import perspective_project as j_persp

    rng = np.random.default_rng(3)
    pts = rng.normal(scale=0.4, size=(B, 40, 3)).astype(np.float32)
    cam_t = bodies[1]
    np.testing.assert_allclose(
        t_persp(t(pts), None, t(cam_t), focal_length=FOCAL, img_wh=IMG).numpy(),
        np.asarray(j_persp(jnp.asarray(pts), None, jnp.asarray(cam_t), focal_length=FOCAL, img_wh=IMG)),
        rtol=0, atol=1e-4,
    )
    np.testing.assert_allclose(
        traster.project_perspective_screen(t(pts), t(cam_t), FOCAL, IMG).numpy(),
        np.asarray(jraster.project_perspective_screen(jnp.asarray(pts), jnp.asarray(cam_t), FOCAL, IMG)),
        rtol=0, atol=1e-4,
    )
    axis, trans = np.array([0.3, -0.5, 0.8], np.float32), np.array([0.1, 0.2, -0.3], np.float32)
    np.testing.assert_allclose(
        aa_rotate_translate_points(t(pts), t(axis), 1.3, t(trans)).numpy(),
        np.asarray(j_rotate_translate(jnp.asarray(pts), jnp.asarray(axis), 1.3, jnp.asarray(trans))),
        rtol=0, atol=1e-6,
    )


def test_rasterize_matches_jax_exact_scan(screen, jax_frags):
    sv, faces = screen
    got = traster.rasterize(sv, faces, IMG, chunk=4096)
    frac = _winner_agreement(got.face_idx.numpy(), jax_frags.face_idx)
    print(f"\nexact scan, port vs JAX: winners agree on {frac:.5f} of the covered pixels")
    assert frac >= WINNER_FRAC
    same = got.face_idx.numpy() == np.asarray(jax_frags.face_idx)
    np.testing.assert_allclose(got.depth.numpy()[same], np.asarray(jax_frags.depth)[same], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got.bary.numpy()[same], np.asarray(jax_frags.bary)[same], rtol=0, atol=1e-5)


def test_raster_twin_matches_jax_exact_scan(screen, jax_frags):
    sv, faces = screen
    depth, (face, w0, w1), planes, overflow = cuda_raster.raster(sv, faces, IMG, cull_sign=0)  # CPU: the twin
    frac = _winner_agreement(face.numpy(), jax_frags.face_idx)
    print(f"\nK4 twin vs JAX exact scan: winners agree on {frac:.5f} of the covered pixels")
    assert frac >= WINNER_FRAC
    assert planes is None and overflow.tolist() == [0] * B
    same = face.numpy() == np.asarray(jax_frags.face_idx)
    np.testing.assert_allclose(depth.numpy()[same], np.asarray(jax_frags.depth)[same], rtol=1e-5, atol=0)
    bary = np.asarray(jax_frags.bary)
    np.testing.assert_allclose(w0.numpy()[same], bary[..., 0][same], rtol=0, atol=1e-4)
    np.testing.assert_allclose(w1.numpy()[same], bary[..., 1][same], rtol=0, atol=1e-4)


def test_raster_twin_contract():
    """Ties go to the lowest face id; negative depths order correctly; bad
    indices are dropped and counted; NaN and degenerate faces never win;
    culling keeps one winding; planes interpolate."""
    verts = t(np.array([[
        [2, 2, 5.0], [14, 3, 5.0], [4, 13, 5.0],      # 0-2: a face at z = 5
        [1, 1, -1.0], [15, 1, -1.0], [1, 15, -1.0],   # 3-5: a face at z = -1 (in front)
        [8, 8, math.nan], [12, 9, 0], [9, 12, 0],     # 6-8: NaN depth
        [3, 3, -9.0], [6, 6, -9.0], [9, 9, -9.0],     # 9-11: degenerate
    ]], np.float32)).repeat(2, 1, 1)
    faces = t(np.array([[0, 1, 2], [0, 1, 2], [3, 4, 5], [6, 7, 8], [9, 10, 11], [0, 1, 99]], np.int32))
    attrs = t(np.arange(6 * 4, dtype=np.float32).reshape(1, 6, 4))  # one linear attr (d0 d1 c) + one constant
    depth, (face, w0, w1), planes, overflow = cuda_raster.raster(verts, faces, 16, attrs=attrs, n_lin=1,
                                                                 z_grads=True)
    assert overflow.tolist() == [1, 1]
    got = set(face[0].unique().tolist())
    assert got == {-1, 0, 2}, got  # face 1 ties face 0 and loses; NaN and degenerate never win
    both = (face[0] == 0)
    assert bool(both.any()) and bool((depth[0][both] == 5.0).all())
    assert bool((depth[0][face[0] == 2] == -1.0).all())
    assert bool((depth[0][face[0] == -1] == 1e9).all())
    a = attrs[0]
    want = (a[face[0].clamp(min=0), 0] * w0[0] + a[face[0].clamp(min=0), 1] * w1[0]) + a[face[0].clamp(min=0), 2]
    assert torch.equal(planes[0, ..., 0][face[0] >= 0], want[face[0] >= 0])
    assert torch.equal(planes[0, ..., 1][face[0] >= 0], a[face[0].clamp(min=0), 3][face[0] >= 0])
    assert bool((planes[0][face[0] < 0] == 0).all())
    masks = [cuda_raster.raster(verts, faces[:3], 16, cull_sign=s)[0] < 1e9 for s in (-1, 0, 1)]
    assert torch.equal(masks[0] | masks[2], masks[1])
    assert not bool((masks[0] & masks[2]).any())


def _render_inputs(bodies, b=B):
    verts, cam_t, textures, lights = bodies
    return verts[:b], cam_t[:b], textures[:b], lights


def test_exact_render_matches_jax(bodies):
    verts, cam_t, textures, lights = _render_inputs(bodies)
    jr = JaxRenderer(img_wh=IMG, projection_type="perspective", focal_length=FOCAL, render_rgb=True, chunk=4096,
                     emit_overflow=True)
    tr = TorchRenderer(img_wh=IMG, projection_type="perspective", focal_length=FOCAL, render_rgb=True, chunk=4096,
                       emit_overflow=True, device="cpu")
    want = jr(jnp.asarray(verts), cam_t=jnp.asarray(cam_t), textures=jnp.asarray(textures),
              lights_rgb_settings={k: jnp.asarray(v) for k, v in lights.items()})
    got = tr(t(verts), cam_t=t(cam_t), textures=t(textures), lights_rgb_settings={k: t(v) for k, v in lights.items()})
    assert set(got) == set(want)
    assert int(got["binning_overflow"]) == 0
    _assert_images_close(got, want)


def _assert_images_close(got, want):
    np.testing.assert_array_equal(got["silhouettes"].numpy(), np.asarray(want["silhouettes"]))
    for k in ("iuv_images", "depth_images", "rgb_images"):
        if k not in want:
            continue
        g, w = got[k].numpy(), np.asarray(want[k])
        assert g.shape == w.shape, k
        close = np.abs(g - w) <= IMG_ATOL + 1e-6 * np.abs(w)
        print(f"{k}: {close.mean():.5f} of the values within {IMG_ATOL}")
        assert close.mean() >= WINNER_FRAC, k


def _standin(verts_screen, faces, image_size, lin_attrs=None, const_attrs=None, z_grads=False, emit_frags=True,
             cull_sign=0, **_):
    """rasterize_binned_with_attrs on JAX's exact scan (see module doc)."""
    assert cull_sign == 0
    frags = jraster.rasterize(verts_screen, faces, image_size, chunk=4096)
    b, f = verts_screen.shape[0], faces.shape[0]
    fidx = jnp.maximum(frags.face_idx, 0)
    pick = jax.vmap(lambda table, idx: table[idx])
    planes = []
    if lin_attrs is not None:
        la = jnp.broadcast_to(lin_attrs, (b, f) + lin_attrs.shape[2:])
        planes.append(jnp.einsum("...k,...kd->...d", frags.bary, pick(la, fidx)))
    if const_attrs is not None:
        planes.append(pick(jnp.broadcast_to(const_attrs, (b, f, const_attrs.shape[-1])), fidx))
    if z_grads:
        coefs = jax.vmap(jbinned._edge_plane_coeffs)(verts_screen[:, faces].reshape(b, f, 9))
        planes.append(pick(coefs[..., 6:8], fidx))
    planes = jnp.where(frags.mask[..., None], jnp.concatenate(planes, axis=-1), 0.0)
    zeros = jnp.zeros((b,), jnp.int32)
    return frags, planes, zeros, zeros


@pytest.mark.parametrize("sampling,emit_uv,rgb", [("face", False, True), ("pixel", True, True),
                                                  ("vertex", True, True), ("face", True, False)])
def test_fused_render_matches_jax_with_standin(bodies, monkeypatch, sampling, emit_uv, rgb):
    monkeypatch.setattr(jbinned, "rasterize_binned_with_attrs", _standin)
    verts, cam_t, textures, lights = _render_inputs(bodies, b=2)
    kw = dict(img_wh=IMG, projection_type="perspective", focal_length=FOCAL, render_rgb=rgb,
              texture_sampling=sampling, emit_uv=emit_uv, emit_overflow=True)
    jr, tr = JaxRenderer(**kw), TorchRenderer(**kw, device="cpu")
    jv = jnp.asarray(verts)[:, jr.dp["vertex_map"]]
    tv = t(verts)[:, tr.dp["vertex_map"]]
    jl = {k: jnp.asarray(v) for k, v in lights.items()}
    want = jr._render_binned_fused(jr._screen_verts(jv, jnp.asarray(cam_t)), jv, jnp.asarray(cam_t), None,
                                   jnp.asarray(textures), jl, None, rgb)
    got = tr._render_binned_fused(tr._screen_verts(tv, t(cam_t)), tv, t(cam_t), None, t(textures),
                                  {k: t(v) for k, v in lights.items()}, None, rgb)
    assert set(got) == set(want) and int(got["binning_overflow"]) == 0
    _assert_images_close(got, want)


def test_binned_renderer_routes_to_the_exact_scan_on_the_cpu(bodies):
    verts, cam_t, textures, lights = _render_inputs(bodies, b=1)
    binned = TorchRenderer(img_wh=IMG, projection_type="perspective", focal_length=FOCAL, rasterizer="binned",
                           texture_sampling="face", device="cpu")
    exact = TorchRenderer(img_wh=IMG, projection_type="perspective", focal_length=FOCAL, device="cpu")
    assert binned.rasterizer == "xla"
    a = binned(t(verts), cam_t=t(cam_t), textures=t(textures))
    b = exact(t(verts), cam_t=t(cam_t), textures=t(textures))
    for k in b:
        assert torch.equal(a[k], b[k]), k
    # the tiled backend (kernel K6) routes the same way: kept off the CPU at
    # img_wh % 128 == 0, the exact scan on the CPU
    assert TorchRenderer(img_wh=128, rasterizer="tiled", device="meta").rasterizer == "tiled"
    assert TorchRenderer(img_wh=128, rasterizer="tiled", device="cpu").rasterizer == "xla"
