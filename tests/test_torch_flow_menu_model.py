"""HumaniflowModel.apply under every non-default flow variant against
humaniflow_tpu on the CPU: samples, point estimate and the log-density of
targets with the same weights and JAX's noise.  Where the JAX model's
stacked flow is not right (masked transforms, the unconditional linear PLU,
BatchNorm), its flow runs part by part (tests/_torch_parity.py::PerPartFlow).
The transforms themselves: tests/test_torch_flow_menu.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import jax_noise, menu_model_pair, t
from scipy.spatial.transform import Rotation

from humaniflow_torch.flows import cuda_level

# Whole-model outputs with shared noise: 5e-4 absolute, as
# tests/test_torch_model.py; log-densities rtol 2e-4 / atol 2e-3
# (docs/PARITY.md:38).
MODEL_ATOL = 5e-4
LP_RTOL, LP_ATOL = 2e-4, 2e-3
B, N = 2, 3

# (transform type, permute type, BatchNorm, extra config): every transform
# type and every permute type.  The masked spline runs one block of 2 bins:
# JAX compiles its 4·bins − 1 per-block MLPs one by one, for each event dim,
# level and block (~150 s on the CPU at the default 2 blocks of 8 bins).
VARIANTS = [
    ("spline_coupling", None, False, {}),
    ("additive_coupling", "permute", False, {}),
    ("affine_coupling", "conditional_linear_plu", True, {}),
    ("spline_masked", "linear_plu", False, dict(num_transforms=1, num_spline_segments=2)),
    ("affine_masked", "permute", True, {}),
]


def _rotations(n, seed):
    v = np.random.default_rng(seed).normal(scale=0.6, size=(n, 3))
    return Rotation.from_rotvec(v).as_matrix().astype(np.float32)


@pytest.mark.parametrize("variant", VARIANTS, ids=lambda v: f"{v[0]}-{v[1]}-bn{int(v[2])}")
def test_model_forward_matches_jax(variant, monkeypatch):
    """From the same encoder features (the encoder is held by
    tests/test_torch_model.py).  HFT_FUSED_LEVEL=1, the JAX package's
    switch, is set and the port ignores it: its fused level refuses these
    flows, so they run eager, as in JAX."""
    transform_type, permute_type, batch_norm, extra = variant
    jm, jparams, tm, _, _ = menu_model_pair(transform_type, permute_type, batch_norm, **extra)
    rng = np.random.default_rng(5)
    feats = rng.normal(size=(B, 512)).astype(np.float32)
    pose = _rotations(B * 23, 6).reshape(B, 23, 3, 3)
    glob = _rotations(B, 7)
    shape = rng.normal(size=(B, 10)).astype(np.float32)
    key = jax.random.PRNGKey(8)

    @jax.jit
    def jax_fwd(p, f, sh, po, gl):
        out = jm.apply(p, input_feats=f, key=key, num_samples=N, compute_for_loglik=True, shape_for_loglik=sh,
                       pose_R_for_loglik=po, glob_R_for_loglik=gl)
        return out, jm.pose_log_prob(p, po, out["pose_flow_contexts_for_loglik"])

    want, want_lp = jax_fwd(jparams, *map(jnp.asarray, (feats, shape, pose, glob)))
    shape_noise, levels = jax_noise(jm, key, B, N)
    monkeypatch.setenv("HFT_FUSED_LEVEL", "1")
    with torch.no_grad():
        got = tm.apply(input_feats=t(feats), num_samples=N, compute_for_loglik=True, shape_for_loglik=t(shape),
                       pose_R_for_loglik=t(pose), glob_R_for_loglik=t(glob), base_noise=[t(z) for z in levels],
                       shape_noise=t(shape_noise))
        got_lp = tm.pose_log_prob(t(pose), got["pose_flow_contexts_for_loglik"])
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=MODEL_ATOL, rtol=0, err_msg=k)
    assert np.isfinite(got_lp.numpy()).all()
    np.testing.assert_allclose(got_lp.numpy(), np.asarray(want_lp), rtol=LP_RTOL, atol=LP_ATOL)
    # the fused level (K5) refuses every non-default flow
    assert not cuda_level.supports_flow(tm.flow) and not tm._fused_level_enabled()
