"""K2's restructured backward and K3's band plan on the CPU.

K2's backward is a per-vertex part, (dp, G12), computed by a kernel on the
card and by its plain twin here, followed by float32 products over V.  The
twin and the whole backward are held against the JAX package's custom VJP
(`_lbs_bwd`, `_fused_bwd` of humaniflow_tpu/models/pallas_lbs.py) on the
same numpy inputs.  K3's band plan is checked to cover every row once
within its shared-memory budget.  The kernels themselves are held against
the twins on the card in tests/test_torch_kernels.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import rel_err, t

import humaniflow_tpu.models.pallas_lbs as jlbs
from humaniflow_torch.models import cuda_lbs
from humaniflow_torch.render import cuda_coverage

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
