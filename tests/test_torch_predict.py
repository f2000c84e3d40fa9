"""The port's predict slice against humaniflow_tpu on the CPU: Canny,
heatmaps, proxy, variance, and predict_humaniflow as a whole with the same
weights (params_from_jax) and the same noise."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import IMG, jax_noise, jax_params_from_port, small_cfgs, t

from humaniflow_torch.data.label_conversions import convert_2d_joints_to_gaussian_heatmaps as t_heatmaps
from humaniflow_torch.models import HumaniflowModel as TorchModel
from humaniflow_torch.models import CannyEdgeDetector as TorchCanny
from humaniflow_torch.models import smpl as tsmpl
from humaniflow_torch.pipelines import predict as tpredict
from humaniflow_torch.utils.convert_jax import params_from_jax
from humaniflow_torch.utils.sampling import compute_vertex_variance_from_samples as t_variance
from humaniflow_tpu.data.label_conversions import convert_2d_joints_to_gaussian_heatmaps as j_heatmaps
from humaniflow_tpu.models import HumaniflowModel as JaxModel
from humaniflow_tpu.models import CannyEdgeDetector as JaxCanny
from humaniflow_tpu.models import synthetic_smpl as j_synthetic_smpl
from humaniflow_tpu.pipelines import predict as jpredict
from humaniflow_tpu.utils.sampling import compute_vertex_variance_from_samples as j_variance

# Dense outputs (blur, gradients, heatmaps, proxy channels other than the
# thin edges): 1e-5.  The binned orientation and the thin edges: at most 0.1%
# of pixels may differ, where round(arctan2/45) meets an orientation tie that
# the two frameworks' arctan2 break differently.  The slice as a whole: 5e-4, as the model.
DENSE_ATOL = 1e-5
EDGE_TIE_FRACTION = 1e-3
SLICE_ATOL = 5e-4
B, N = 2, 4


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:IMG, 0:IMG] / IMG
    blobs = np.stack([np.sin(6 * xx + c) * np.cos(5 * yy - c) for c in range(3)], -1)
    images = np.clip(0.5 + 0.4 * blobs[None] + rng.normal(scale=0.05, size=(B, IMG, IMG, 3)), 0, 1)
    joints2d = rng.uniform(4, IMG - 4, size=(B, 17, 2))
    conf = rng.uniform(size=(B, 17))
    return images.astype(np.float32), joints2d.astype(np.float32), conf.astype(np.float32)


def _edge_mismatch(got, want) -> float:
    return float(np.mean(np.abs(got - want) > DENSE_ATOL))


@pytest.mark.parametrize("nms,threshold", [(True, 0.0), (True, 0.2), (False, 0.1)])
def test_canny_matches_jax(nms, threshold):
    images, _, _ = _inputs(1)
    kw = dict(non_max_suppression=nms, threshold=threshold)
    want = JaxCanny(**kw)(jnp.asarray(images))
    got = TorchCanny(**kw)(t(images))
    assert set(got) == set(want)
    for k in want:
        if k in ("grad_orientation", "thin_edges", "thresholded_thin_edges"):
            assert _edge_mismatch(got[k].numpy(), np.asarray(want[k])) <= EDGE_TIE_FRACTION, k
        else:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=DENSE_ATOL, rtol=0, err_msg=k)


def test_heatmaps_and_variance_match_jax():
    _, joints2d, _ = _inputs(2)
    np.testing.assert_allclose(
        t_heatmaps(t(joints2d), IMG, std=4.0).numpy(), np.asarray(j_heatmaps(jnp.asarray(joints2d), IMG, 4.0)),
        atol=DENSE_ATOL, rtol=0,
    )
    verts = np.random.default_rng(3).normal(scale=0.1, size=(B, 6, 50, 3)).astype(np.float32)
    for got, want in zip(t_variance(t(verts)), j_variance(jnp.asarray(verts))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)


def test_build_proxy_matches_jax():
    jcfg, tcfg = small_cfgs()
    images, joints2d, conf = _inputs(4)
    want = np.asarray(jpredict.build_proxy_representation(
        jnp.asarray(images), jnp.asarray(joints2d), jnp.asarray(conf), jcfg))
    got = tpredict.build_proxy_representation(t(images), t(joints2d), t(conf), tcfg).numpy()
    assert got.shape == (B, IMG, IMG, 18)
    assert _edge_mismatch(got[..., 0], want[..., 0]) <= EDGE_TIE_FRACTION
    np.testing.assert_allclose(got[..., 1:], want[..., 1:], atol=DENSE_ATOL, rtol=0)


@pytest.fixture(scope="module")
def slice_pair():
    """JAX and port predict_humaniflow on the same weights, SMPL and noise."""
    jcfg, tcfg = small_cfgs()
    jm = JaxModel(jcfg.MODEL)
    source = TorchModel(tcfg.MODEL, device="cpu", generator=torch.Generator().manual_seed(5))
    jparams = jax_params_from_port(source, jm)
    tm = params_from_jax(jparams, TorchModel(tcfg.MODEL, device="cpu"))
    jsmpl = j_synthetic_smpl(num_verts=128)
    tsm = tsmpl.synthetic_smpl(num_verts=128, device="cpu")
    images, joints2d, conf = _inputs(5)
    key = jax.random.PRNGKey(0)
    want = jpredict.predict_humaniflow(jm, jparams, jsmpl, jcfg, images, joints2d, conf, num_samples=N, key=key)
    _, levels = jax_noise(jm, key, B, N)
    got = tpredict.predict_humaniflow(
        tm, tsm, tcfg, images, joints2d, conf, num_samples=N, device="cpu",
        base_noise=[t(z) for z in levels],
    )
    return want, got, (tm, tsm, tcfg, images, joints2d, conf)


def test_predict_humaniflow_matches_jax(slice_pair):
    want, got, _ = slice_pair
    assert set(got) == set(want)
    proxy, want_proxy = got["proxy_rep"].numpy(), np.asarray(want["proxy_rep"])
    assert _edge_mismatch(proxy[..., 0], want_proxy[..., 0]) <= EDGE_TIE_FRACTION
    np.testing.assert_allclose(proxy[..., 1:], want_proxy[..., 1:], atol=DENSE_ATOL, rtol=0)
    for k in want:
        if k != "proxy_rep":
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=SLICE_ATOL, rtol=0, err_msg=k)
    assert got["verts_samples"].shape == (B, N, 128, 3)


def test_moments_program_matches_predict_variance(slice_pair):
    """The distribution-inference program (model → K1 moments → variance)
    gives the variance of predict's own vertex samples, for the same noise."""
    _, got, (tm, tsm, _, _, _, _) = slice_pair
    b, n = B, N
    mom = tsmpl.smpl_vertex_moments(
        tsm, got["shape_samples"].reshape(b * n, -1), got["pose_rotmats_samples"].reshape(b * n, 23, 3, 3),
        got["glob_rotmat"][:, None].expand(b, n, 3, 3).reshape(b * n, 3, 3), num_groups=b,
    )
    var = torch.clamp(mom[:, 1] / n - (mom[:, 0] / n) ** 2, min=0).sum(1)
    want = (got["vertex_uncertainty_directional"] ** 2).sum(-1)
    torch.testing.assert_close(var, want, rtol=1e-3, atol=1e-7)


def test_save_pred_output_writes_one_file_per_image(slice_pair, tmp_path):
    _, got, _ = slice_pair
    tpredict.save_pred_output(got, ["a.png", "b.jpg"], str(tmp_path), extras={"bbox": np.ones((B, 4))})
    saved = np.load(tmp_path / "b_pred.npz")
    np.testing.assert_array_equal(saved["shape_mode"], got["shape_mode"][1].numpy())
    assert saved["bbox"].shape == (4,) and sorted(p.name for p in tmp_path.iterdir()) == ["a_pred.npz", "b_pred.npz"]
