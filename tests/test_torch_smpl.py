"""humaniflow_torch SMPL against humaniflow_tpu on the CPU.  Kernels K1/K2
against their plain twins on a GPU: tests/test_torch_kernels.py."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import t
from scipy.spatial.transform import Rotation

from humaniflow_torch.models import cuda_lbs
from humaniflow_torch.models import smpl as tsmpl
from humaniflow_torch.utils.convert_jax import smpl_from_numpy
from humaniflow_tpu.models import smpl as jsmpl

# Vertices and joints: 1e-5 m (float32 sums over ≤ 217 blend terms and 24
# joints in another order).  Moments: 1e-5 relative.
VERT_ATOL = 1e-5
MOM_RTOL = 1e-5


def _jax_fields(m):
    return {f.name: None if getattr(m, f.name) is None else np.asarray(getattr(m, f.name))
            for f in dataclasses.fields(m)}


@pytest.fixture(scope="module")
def models():
    jm = jsmpl.synthetic_smpl(num_verts=128)
    return jm, smpl_from_numpy(_jax_fields(jm), device="cpu")


def _pose_batch(b, seed=7, nb=10):
    rng = np.random.default_rng(seed)
    betas = rng.normal(scale=0.8, size=(b, nb)).astype(np.float32)
    rots = Rotation.random(b * 24, random_state=seed).as_matrix().reshape(b, 24, 3, 3).astype(np.float32)
    return betas, rots[:, 1:], rots[:, 0]


@pytest.mark.parametrize("num_verts", [128, 6890])
def test_synthetic_smpl_matches_jax(num_verts):
    """Same seed, same arrays, bit for bit (V=6890 takes the DensePose-
    coherent branch through the port's own UV_Processed.mat reader)."""
    want = _jax_fields(jsmpl.synthetic_smpl(num_verts=num_verts))
    got = tsmpl.synthetic_smpl(num_verts=num_verts, device="cpu")
    for name, a in want.items():
        b = getattr(got, name)
        if a is None:
            assert b is None, name
        else:
            np.testing.assert_array_equal(b.numpy(), a, err_msg=name)


@pytest.mark.parametrize("pose2rot", [False, True])
def test_smpl_forward_matches_jax(models, pose2rot):
    jm, tm = models
    betas, body, glob = _pose_batch(6)
    if pose2rot:
        body = Rotation.from_matrix(body.reshape(-1, 3, 3)).as_rotvec().reshape(6, 69).astype(np.float32)
        glob = Rotation.from_matrix(glob).as_rotvec().astype(np.float32)
    want = jsmpl.smpl_forward(jm, jnp.asarray(betas), jnp.asarray(body), jnp.asarray(glob), pose2rot=pose2rot)
    got = tsmpl.smpl_forward(tm, t(betas), t(body), t(glob), pose2rot=pose2rot)
    for key in ("vertices", "vertices_cm", "joints", "smpl_joints"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=VERT_ATOL, rtol=0, err_msg=key)
    assert got["joints"].shape == (6, 90, 3)


def test_smpl_vertex_moments_matches_jax(models):
    jm, tm = models
    g, n = 3, 5
    betas, body, glob = _pose_batch(g * n, seed=8)
    want = np.asarray(jsmpl.smpl_vertex_moments(jm, jnp.asarray(betas), jnp.asarray(body), jnp.asarray(glob), g))
    got = tsmpl.smpl_vertex_moments(tm, t(betas), t(body), t(glob), num_groups=g).numpy()
    assert got.shape == (g, 2, 3, 128)
    np.testing.assert_allclose(got, want, rtol=MOM_RTOL, atol=MOM_RTOL * np.abs(want).max())


def test_load_smpl_npz_matches_jax(tmp_path):
    rng = np.random.default_rng(9)
    v = 6890  # the landmark vertex ids index the real SMPL mesh
    path = str(tmp_path / "smpl.npz")
    f32 = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    np.savez(
        path,
        v_template=f32(v, 3), shapedirs=f32(v, 3, 12), posedirs=f32(207, 3 * v),
        J_regressor=f32(24, v), weights=f32(v, 24), f=rng.integers(0, v, size=(50, 3)),
    )
    want = _jax_fields(jsmpl.load_smpl_npz(path))
    got = tsmpl.load_smpl_npz(path, device="cpu")
    for name, a in want.items():
        if name == "extra_joint_vertex_ids" or a is None:
            continue
        np.testing.assert_array_equal(getattr(got, name).numpy(), a, err_msg=name)


def test_kernel_wrappers_take_plain_twins_on_cpu(models):
    """On CPU tensors the wrappers compute the plain twins and launch nothing."""
    _, tm = models
    betas, body, glob = _pose_batch(6, seed=10)
    _, a12, pf = tsmpl._kernel_inputs(tm, t(betas), t(body), t(glob))
    model_args = (tm.v_template_cm, tm.shapedirs_cm, tm.posedirs_cm, tm.lbs_weights)
    before = dict(cuda_lbs.LAUNCHES)
    verts = cuda_lbs.smpl_verts(a12, t(betas), pf, *model_args)
    torch.testing.assert_close(verts, cuda_lbs.smpl_verts_plain(a12, t(betas), pf, *model_args), rtol=0, atol=0)
    mom = cuda_lbs.smpl_moments(a12.reshape(2, 3, 24, 12), t(betas).reshape(2, 3, 10), pf.reshape(2, 3, 207), *model_args)
    v = verts.reshape(2, 3, 3, -1)
    torch.testing.assert_close(mom, torch.stack([v.sum(1), (v * v).sum(1)], 1), rtol=MOM_RTOL, atol=1e-6)
    assert cuda_lbs.LAUNCHES == before
