"""The port's public surface covers the JAX package's: every name in every
`humaniflow_tpu/**/__init__.py` `__all__` is exported by the port's matching
subpackage, apart from the exemptions below, each with its reason; and the
names the port took last are held to their JAX functions on the CPU."""

import ast
import glob
import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import jax_noise, jax_params_from_port, rel_err, small_cfgs, t

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# JAX names with no counterpart of the same name, and why.
EXEMPT = {
    ("flows", "init_dense_nn"): "flax's functional init of a dense net; the port's counterpart is the DenseNN module",
    ("flows", "apply_dense_nn"): "flax's functional apply of a dense net; the port's counterpart is DenseNN.forward",
    ("parallel", "batch_sharding"): "returns a jax.sharding object; the port's shard_batch takes its place",
    ("parallel", "replicated"): "returns a jax.sharding object; the port's replicate takes its place",
}
COUNTERPARTS = {("flows", "init_dense_nn"): "DenseNN", ("flows", "apply_dense_nn"): "DenseNN",
                ("parallel", "batch_sharding"): "shard_batch", ("parallel", "replicated"): "replicate"}

QUAT_ATOL = 1e-6  # float32 products of the same formula
OPS_ATOL = 1e-6
FLOW_ATOL = 5e-5  # flow composition (docs/PARITY.md)
METRIC_RTOL = 2e-4  # ResNet and metrics (docs/PARITY.md), as tests/test_torch_eval.py
HAAR_TRACE_ATOL = 0.05  # the mean trace of a Haar rotation is 0; 20,000 draws: standard error ~0.007


def _jax_all():
    """(subpackage, name) of every JAX __all__, by parsing the __init__s."""
    out = []
    for init in sorted(glob.glob(os.path.join(REPO, "humaniflow_tpu", "**", "__init__.py"), recursive=True)):
        sub = os.path.relpath(os.path.dirname(init), os.path.join(REPO, "humaniflow_tpu")).replace(os.sep, ".")
        for node in ast.parse(open(init).read()).body:
            if isinstance(node, ast.Assign) and any(getattr(tg, "id", None) == "__all__" for tg in node.targets):
                out += [(sub, name) for name in ast.literal_eval(node.value)]
    return out


JAX_ALL = _jax_all()


@pytest.mark.parametrize("sub,name", JAX_ALL, ids=[f"{s}.{n}" for s, n in JAX_ALL])
def test_port_exports_the_jax_name(sub, name):
    port = importlib.import_module(f"humaniflow_torch.{sub}")
    if (sub, name) in EXEMPT:
        counterpart = COUNTERPARTS[(sub, name)]
        assert counterpart in port.__all__ and hasattr(port, counterpart), EXEMPT[(sub, name)]
        assert name not in port.__all__
        return
    assert name in getattr(port, "__all__", ()), f"humaniflow_torch.{sub} does not export {name}"
    assert hasattr(port, name)


def test_the_walk_reaches_every_subpackage_and_every_exemption_is_a_jax_name():
    subs = {s for s, _ in JAX_ALL}
    assert subs == {"configs", "data", "flows", "losses", "metrics", "models", "ops", "parallel", "pipelines",
                    "render", "utils"}
    assert set(EXEMPT) <= set(JAX_ALL) and set(COUNTERPARTS) == set(EXEMPT)


# ---------------------------------------------------------------- ops


def test_quat_to_rotmat_matches_jax():
    from humaniflow_torch.ops import quat_to_rotmat
    from humaniflow_tpu.ops import quat_to_rotmat as j_quat_to_rotmat

    rng = np.random.default_rng(0)
    q = rng.normal(size=(64, 4)).astype(np.float32)
    q[:16] *= rng.uniform(0.01, 50.0, size=(16, 1)).astype(np.float32)  # not normalised
    q[16] = 0.0  # the clamped norm
    got = quat_to_rotmat(t(q)).numpy()
    np.testing.assert_allclose(got, np.asarray(j_quat_to_rotmat(jnp.asarray(q))), atol=QUAT_ATOL, rtol=0)
    r = got[17:]
    np.testing.assert_allclose(r @ np.swapaxes(r, -1, -2), np.broadcast_to(np.eye(3), r.shape), atol=1e-5)


def test_camera_translation_and_ground_plane_match_jax():
    from humaniflow_torch.ops import convert_weak_perspective_to_camera_translation, make_xz_ground_plane
    from humaniflow_tpu.ops import convert_weak_perspective_to_camera_translation as j_convert
    from humaniflow_tpu.ops import make_xz_ground_plane as j_ground

    rng = np.random.default_rng(1)
    cam = np.concatenate([rng.uniform(0.5, 1.5, (2, 5, 1)), rng.normal(size=(2, 5, 2))], -1).astype(np.float32)
    np.testing.assert_allclose(convert_weak_perspective_to_camera_translation(t(cam), 5000.0, 256).numpy(),
                               np.asarray(j_convert(jnp.asarray(cam), 5000.0, 256)), atol=OPS_ATOL, rtol=1e-6)
    verts = rng.normal(size=(3, 50, 3)).astype(np.float32)
    got = make_xz_ground_plane(t(verts)).numpy()
    np.testing.assert_allclose(got, np.asarray(j_ground(jnp.asarray(verts))), atol=OPS_ATOL, rtol=0)
    np.testing.assert_allclose(got[..., 1].min(-1), 0.0, atol=OPS_ATOL)
    np.testing.assert_array_equal(got[..., [0, 2]], verts[..., [0, 2]])


# ---------------------------------------------------------------- sampling


def test_so3_uniform_sampling_is_haar_and_seeded():
    from humaniflow_torch.utils import so3_uniform_sampling

    def draw(seed, n):
        return so3_uniform_sampling(n, generator=torch.Generator().manual_seed(seed), device="cpu")

    r = draw(0, 20_000)
    assert r.shape == (20_000, 3, 3) and r.dtype == torch.float32
    torch.testing.assert_close(r @ r.transpose(-1, -2), torch.eye(3).expand_as(r), atol=1e-5, rtol=0)
    torch.testing.assert_close(torch.linalg.det(r), torch.ones(20_000), atol=1e-5, rtol=0)
    torch.testing.assert_close(draw(0, 20_000), r, atol=0, rtol=0)
    assert not torch.equal(draw(1, 20_000), r)
    mean_trace = float(r.diagonal(dim1=-2, dim2=-1).sum(-1).mean())
    assert abs(mean_trace) < HAAR_TRACE_ATOL, mean_trace


# ---------------------------------------------------------------- flows


def test_radial_tanh_matches_jax():
    """Forward, inverse and both log-dets, a zero vector among the inputs."""
    from humaniflow_torch.flows import RadialTanh
    from humaniflow_tpu.flows import RadialTanh as JRadialTanh

    rng = np.random.default_rng(2)
    x = (rng.normal(size=(4, 23, 3)) * rng.uniform(0.05, 2.0, size=(4, 23, 1))).astype(np.float32)
    x[0, 0] = 0.0
    x[0, 1] = 1e-9
    jt, tt = JRadialTanh(radius=np.pi), RadialTanh(radius=np.pi)
    want_y, want_ld = jt.forward({}, jnp.asarray(x))
    got_y, got_ld = tt(t(x))
    y = np.asarray(want_y)
    want_x, want_ild = jt.inverse({}, jnp.asarray(y))
    got_x, got_ild = tt.inverse(t(y))
    np.testing.assert_allclose(got_y.numpy(), y, atol=FLOW_ATOL, rtol=0)
    assert np.isfinite(got_ld.numpy()).all() and abs(float(got_ld[0, 0]) - 3 * np.log(np.pi)) < FLOW_ATOL
    # The inverse x = y·atanh(t)/‖y‖ and both log-dets, log R + log(1 - t²)
    # + 2 log(‖y‖ / atanh t), with t = ‖y‖/R, are computed from float32 y:
    # an ulp of t moves x by 1/(1 - t²) and the log-dets by 2t/(1 - t²) +
    # 2/((1 - t²) atanh t), gains of ~1-2 for small ‖x‖ and ~1e4 where tanh
    # saturates (‖x‖ ≈ 5).  So each bound grows by four ulps of t through
    # its gain, and is FLOW_ATOL itself where the gain is below 10.
    t_sq = np.clip((np.linalg.norm(y, axis=-1) / np.pi) ** 2, 0.0, 1.0 - 1e-7)
    t_ = np.sqrt(t_sq)
    ulps = 4 * np.finfo(np.float32).eps * t_
    gain_x = 1 / (1 - t_sq)
    gain_ld = 2 * t_ / (1 - t_sq) + 2 / ((1 - t_sq) * np.maximum(np.arctanh(t_), 1e-6))
    assert (gain_ld < 10).sum() > 20 and (gain_ld > 1e3).any()
    checks = ((got_x, want_x, ulps[..., None] * gain_x[..., None], gain_x[..., None] < 10),
              (got_ld, want_ld, ulps * gain_ld, gain_ld < 10), (got_ild, want_ild, ulps * gain_ld, gain_ld < 10))
    for got, want, slack, calm in checks:
        err = np.abs(got.numpy() - np.asarray(want))
        assert (err <= FLOW_ATOL + slack).all(), float((err - slack).max())
        assert (err[np.broadcast_to(calm, err.shape)] <= FLOW_ATOL).all()


@pytest.mark.parametrize("inverse", [False, True])
def test_monotonic_rational_spline_matches_jax(inverse):
    from humaniflow_torch.flows import monotonic_rational_spline
    from humaniflow_tpu.flows import monotonic_rational_spline as j_spline

    rng = np.random.default_rng(3)
    d, k = 3, 8
    x = rng.uniform(-3.5, 3.5, size=(64, d)).astype(np.float32)  # some outside the bound: the identity
    w, h, lam = (rng.normal(size=(64, d, k)).astype(np.float32) for _ in range(3))
    der = rng.normal(size=(64, d, k - 1)).astype(np.float32)
    want = j_spline(*(jnp.asarray(a) for a in (x, w, h, der, lam)), inverse=inverse)
    got = monotonic_rational_spline(*(t(a) for a in (x, w, h, der, lam)), inverse=inverse)
    for g, wnt in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt), atol=FLOW_ATOL, rtol=0)


# ---------------------------------------------------------------- data, render


def test_convert_multiclass_to_binary_labels_matches_jax():
    from humaniflow_torch.data.label_conversions import convert_multiclass_to_binary_labels
    from humaniflow_tpu.data.label_conversions import convert_multiclass_to_binary_labels as j_binary

    labels = np.random.default_rng(4).integers(0, 5, size=(2, 8, 8)).astype(np.int32)
    for a in (labels, labels.astype(np.float32)):
        want = np.asarray(j_binary(jnp.asarray(a)))
        got_t = convert_multiclass_to_binary_labels(t(a)).numpy()
        got_np = convert_multiclass_to_binary_labels(a)
        for got in (got_t, got_np):
            assert got.dtype == a.dtype
            np.testing.assert_array_equal(got, want)


def test_load_densepose_uv_equals_the_host_reader():
    from humaniflow_torch.render import load_densepose_uv, load_densepose_uv_host

    host = load_densepose_uv_host()
    dev = load_densepose_uv(device="cpu")
    assert sorted(dev) == sorted(host)
    for k, a in host.items():
        assert isinstance(dev[k], torch.Tensor) and dev[k].device.type == "cpu"
        np.testing.assert_array_equal(dev[k].numpy(), a, err_msg=k)


# ---------------------------------------------------------------- pipelines, profiling


def test_make_eval_step_matches_jax():
    """One batch through both packages' make_eval_step at small_cfgs, the
    same weights and the JAX key's noise: the step's outputs and the 3DPW
    point and sample metrics on them within rel 2e-4."""
    from humaniflow_torch.metrics import compute_batch_metrics
    from humaniflow_torch.models import HumaniflowModel as TorchModel
    from humaniflow_torch.models import synthetic_smpl
    from humaniflow_torch.pipelines import make_eval_step
    from humaniflow_torch.utils.convert_jax import params_from_jax
    from humaniflow_tpu.metrics import compute_batch_metrics as j_metrics
    from humaniflow_tpu.models import HumaniflowModel as JaxModel
    from humaniflow_tpu.models import synthetic_smpl as j_synthetic_smpl
    from humaniflow_tpu.pipelines import make_eval_step as j_make_eval_step

    jcfg, tcfg = small_cfgs(18)
    b, n, img = 2, 3, tcfg.DATA.PROXY_REP_SIZE
    jm = JaxModel(jcfg.MODEL)
    source = TorchModel(tcfg.MODEL, device="cpu", generator=torch.Generator().manual_seed(8))
    jparams = jax_params_from_port(source, jm)
    tm = params_from_jax(jparams, TorchModel(tcfg.MODEL, device="cpu"))
    jsmpl = [j_synthetic_smpl(num_verts=6890, seed=s) for s in (0, 1, 2)]
    tsmpl = [synthetic_smpl(num_verts=6890, seed=s, device="cpu") for s in (0, 1, 2)]
    rng = np.random.default_rng(5)
    batch = {
        "image": rng.integers(0, 256, (b, img, img, 3)).astype(np.uint8),
        "pose": rng.normal(scale=0.3, size=(b, 72)).astype(np.float32),
        "shape": rng.normal(scale=0.5, size=(b, 10)).astype(np.float32),
        "is_female": np.array([0.0, 1.0], np.float32),
        "input_joints2D": rng.integers(4, img - 4, (b, 17, 2)).astype(np.float32),
        "input_joints2D_vis": rng.uniform(size=(b, 17)) < 0.8,
    }
    key = jax.random.PRNGKey(4)
    j_step = j_make_eval_step(jm, *jsmpl, jcfg, n, True, True)
    want = j_step(jparams, {k: jnp.asarray(v) for k, v in batch.items()}, key)
    shape_noise, levels = jax_noise(jm, key, b, n)
    t_step = make_eval_step(tm, *tsmpl, tcfg, n, True, True, renderer=None)
    got = t_step({k: t(v) for k, v in batch.items()}, noise=(t(shape_noise.astype(np.float32)), [t(z) for z in levels]))
    for part, (g, w) in enumerate(zip(got, want)):
        if part == 2:  # the proxy: its thin edges may differ at orientation ties (tests/test_torch_predict.py)
            continue
        assert set(g) == set(w), part
        for k in w:
            assert rel_err(g[k].numpy(), np.asarray(w[k])) <= METRIC_RTOL, (part, k)
    metrics = ("PVE", "PVE-SC", "PVE-PA", "PVE-T-SC", "MPJPE", "MPJPE-SC", "MPJPE-PA", "PVE_samples_min",
               "PVE-SC_samples_min", "MPJPE-PA_samples_min", "verts3D_sample_diversity")
    want_pf, _ = j_metrics(metrics, *want[:2], num_samples=n)
    got_pf, _ = compute_batch_metrics(metrics, *got[:2], num_samples=n)
    for m in metrics:
        assert rel_err(got_pf[m].numpy(), np.asarray(want_pf[m])) <= METRIC_RTOL, m


def test_stage_timer():
    """The assertions of the JAX package's StageTimer test, and a stage
    block with a result to wait for."""
    from humaniflow_torch.utils.profiling import StageTimer

    timer = StageTimer()
    x = torch.ones((8, 8))
    for _ in range(3):
        timer.time_stage("add", lambda: x + 1)
    with timer.stage("matmul", sync_result={"y": [x @ x]}):
        pass
    s = timer.summary()
    assert s["add"]["count"] == 3 and s["matmul"]["count"] == 1
    assert s["add"]["total_s"] > 0
    assert "add" in timer.report() and "matmul" in timer.report()
