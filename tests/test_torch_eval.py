"""The port's evaluation slice against humaniflow_tpu on the CPU: rotation
and keypoint helpers, alignments, batch metrics, the eval datasets, and
evaluate_humaniflow as a whole for both shipped protocols, with the same
weights (params_from_jax) and the same noise (the JAX key pool)."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import jax_noise, jax_params_from_port, rel_err, t

from humaniflow_torch.configs import get_humaniflow_cfg_defaults as torch_defaults
from humaniflow_torch.data import datasets as tdata
from humaniflow_torch.data.label_conversions import convert_2d_joints_to_gaussian_heatmaps as t_heatmaps
from humaniflow_torch.data.label_conversions import convert_heatmaps_to_2d_joints_coordinates as t_decode
from humaniflow_torch.metrics import EvalMetricsTracker, compute_batch_metrics as t_metrics
from humaniflow_torch.metrics import undo_keypoint_normalisation as t_undo
from humaniflow_torch.models import HumaniflowModel as TorchModel
from humaniflow_torch.models import synthetic_smpl as t_synthetic_smpl
from humaniflow_torch.ops import aa_rotate_rotmats as t_aa_rotate
from humaniflow_torch.ops import procrustes_analysis_batch as t_procrustes
from humaniflow_torch.ops import scale_and_translation_transform_batch as t_scale_trans
from humaniflow_torch.ops import so3_exp
from humaniflow_torch.pipelines import EVAL_METRICS_3DPW, EVAL_METRICS_SSP3D
from humaniflow_torch.pipelines import evaluate_humaniflow as t_evaluate
from humaniflow_torch.render import TexturedIUVRenderer as TorchRenderer
from humaniflow_torch.utils.convert_jax import params_from_jax
from humaniflow_tpu.configs import get_humaniflow_cfg_defaults as jax_defaults
from humaniflow_tpu.data import datasets as jdata
from humaniflow_tpu.data.label_conversions import convert_heatmaps_to_2d_joints_coordinates as j_decode
from humaniflow_tpu.metrics import compute_batch_metrics as j_metrics
from humaniflow_tpu.metrics import undo_keypoint_normalisation as j_undo
from humaniflow_tpu.models import HumaniflowModel as JaxModel
from humaniflow_tpu.models import synthetic_smpl as j_synthetic_smpl
from humaniflow_tpu.ops import procrustes_analysis_batch as j_procrustes
from humaniflow_tpu.ops import scale_and_translation_transform_batch as j_scale_trans
from humaniflow_tpu.ops.rotation import aa_rotate_rotmats as j_aa_rotate
from humaniflow_tpu.pipelines import protocols as jprotocols
from humaniflow_tpu.pipelines.evaluate import evaluate_humaniflow as j_evaluate
from humaniflow_tpu.render import TexturedIUVRenderer as JaxRenderer

# Helpers (rotations, keypoints): 1e-5.  Alignments and metrics: rel 2e-4
# (docs/PARITY.md).  The slice: final and per-frame metrics rel 2e-4, except
# the two IOU metrics at abs 2e-2 — a vertex that moves by 1e-6 m can flip a
# pixel on a silhouette's edge, and one pixel is about 1% of a small
# silhouette.
HELPER_ATOL = 1e-5
METRIC_RTOL = 2e-4
IOU_ATOL = 2e-2
IMG = 32
B, N = 2, 3


def test_aa_rotate_rotmats_matches_jax():
    rng = np.random.default_rng(0)
    r = np.asarray(so3_exp(t(rng.normal(size=(5, 3)).astype(np.float32))))
    for order in ("pre", "post"):
        want = j_aa_rotate(jnp.asarray(r), jnp.asarray([1.0, 0.0, 0.0]), np.pi, rot_mult_order=order)
        got = t_aa_rotate(t(r), torch.tensor([1.0, 0.0, 0.0]), np.pi, rot_mult_order=order)
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=HELPER_ATOL, rtol=0)
        # the axis-angle outputs, compared as the rotations they stand for
        np.testing.assert_allclose(so3_exp(got[0]).numpy(), so3_exp(t(np.asarray(want[0]))).numpy(),
                                   atol=HELPER_ATOL, rtol=0)
    axes = rng.normal(size=(5, 3)).astype(np.float32)
    angles = rng.uniform(-3, 3, size=(5, 1)).astype(np.float32)
    want = j_aa_rotate(jnp.asarray(r), jnp.asarray(axes), jnp.asarray(angles))
    got = t_aa_rotate(t(r), t(axes), t(angles))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=HELPER_ATOL, rtol=0)


def test_heatmap_decode_and_keypoint_normalisation_match_jax():
    rng = np.random.default_rng(1)
    joints = rng.integers(0, IMG, size=(3, 17, 2)).astype(np.float32)
    heat = t_heatmaps(t(joints), IMG).numpy()
    heat[0, 3] = 0.0  # an invisible joint
    heat[1] *= 0.5  # a batch-relative visibility cut
    for gaussian in (False, True):
        want = j_decode(jnp.asarray(heat), gaussian_heatmaps=gaussian)
        got = t_decode(t(heat), gaussian_heatmaps=gaussian)
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=HELPER_ATOL, rtol=0)
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    j2d = rng.uniform(-1, 1, size=(3, 17, 2)).astype(np.float32)
    np.testing.assert_allclose(t_undo(t(j2d), 256).numpy(), np.asarray(j_undo(jnp.asarray(j2d), 256)),
                               atol=HELPER_ATOL, rtol=0)


def test_alignments_match_jax():
    rng = np.random.default_rng(2)
    target = rng.normal(scale=0.3, size=(6, 200, 3)).astype(np.float32)
    rot = np.asarray(so3_exp(t(rng.normal(size=(6, 3)).astype(np.float32))))
    pred = 1.3 * np.einsum("bij,bkj->bki", rot, target) + 0.2 + rng.normal(scale=0.02, size=target.shape)
    pred[0] = pred[0] * np.array([-1.0, 1.0, 1.0])  # a reflection for the SVD fix
    pred = pred.astype(np.float32)
    for tf, jf in ((t_procrustes, j_procrustes), (t_scale_trans, j_scale_trans)):
        want = np.asarray(jf(jnp.asarray(pred), jnp.asarray(target)))
        assert rel_err(tf(t(pred), t(target)).numpy(), want) <= METRIC_RTOL


def _metric_inputs(b=3, n=4, v=60, img=16, seed=3):
    rng = np.random.default_rng(seed)
    f = lambda *s, sc=0.3: rng.normal(scale=sc, size=s).astype(np.float32)  # noqa: E731
    verts = f(b, v, 3)
    pred = {
        "verts3D": verts + f(b, v, 3, sc=0.05), "tpose_verts3D": f(b, v, 3),
        "joints3D": f(b, 14, 3), "joints2D": rng.uniform(0, img, (b, 17, 2)).astype(np.float32),
        "verts3D_samples": verts[:, None] + f(b, n, v, 3, sc=0.05), "tpose_verts3D_samples": f(b, n, v, 3),
        "joints3D_samples": f(b, n, 14, 3), "joints3D_coco_samples": f(b, n, 17, 3),
        "joints2Dsamples": rng.uniform(0, img, (b, n, 17, 2)).astype(np.float32),
        "silhouettes": (rng.uniform(size=(b, img, img)) < 0.4).astype(np.float32),
        "silhouettessamples": rng.uniform(size=(b, n, img, img)) < 0.4,
    }
    target = {
        "verts3D": verts, "tpose_verts3D": f(b, v, 3), "joints3D": f(b, 14, 3),
        "joints2D": rng.uniform(0, img, (b, 17, 2)).astype(np.float32),
        "joints2D_vis": rng.uniform(size=(b, 17)) < 0.8,
        "silhouettes": (rng.uniform(size=(b, img, img)) < 0.4).astype(np.uint8),
    }
    input_j2d = rng.uniform(0, img, (b, 17, 2)).astype(np.float32)
    input_vis = rng.uniform(size=(b, 17)) < 0.7
    return pred, target, input_j2d, input_vis, n


def test_compute_batch_metrics_matches_jax():
    metrics = tuple(sorted(set(EVAL_METRICS_3DPW) | set(EVAL_METRICS_SSP3D))) + (
        "PVE", "PVE-T", "input_joints2D-L2E", "input_joints2Dsamples-L2E",
    )
    assert list(EVAL_METRICS_3DPW) == list(jprotocols.EVAL_METRICS_3DPW)
    assert list(EVAL_METRICS_SSP3D) == list(jprotocols.EVAL_METRICS_SSP3D)
    pred, target, input_j2d, input_vis, n = _metric_inputs()
    jtree = lambda d: {k: jnp.asarray(v) for k, v in d.items()}  # noqa: E731
    ttree = lambda d: {k: t(v) for k, v in d.items()}  # noqa: E731
    want_pf, want_sums = j_metrics(metrics, jtree(pred), jtree(target), jnp.asarray(input_j2d),
                                   jnp.asarray(input_vis), n)
    got_pf, got_sums = t_metrics(metrics, ttree(pred), ttree(target), t(input_j2d), t(input_vis), n)
    assert set(got_pf) == set(want_pf) and set(got_sums) == set(want_sums)
    for k in want_pf:
        assert rel_err(got_pf[k].numpy(), want_pf[k]) <= METRIC_RTOL, k
    for k in want_sums:
        assert rel_err(got_sums[k].numpy(), want_sums[k]) <= METRIC_RTOL, k


def test_tracker_deferred_sync_matches_per_batch_sync(tmp_path, capsys):
    metrics = ("PVE", "PVE-PA", "MPJPE", "joints2D-L2E", "silhouette-IOU", "PVE_samples_min")
    finals = {}
    for sync in (1, 3):
        tracker = EvalMetricsTracker(metrics, save_path=str(tmp_path / str(sync)), save_per_frame_metrics=True,
                                     num_samples_for_prob_metrics=4, sync_every=sync)
        for seed in range(5):
            pred, target, _, _, _ = _metric_inputs(seed=seed)
            tracker.update_per_batch({k: t(v) for k, v in pred.items()}, {k: t(v) for k, v in target.items()}, 3)
            assert tracker.pending_batches == (0 if sync == 1 else (seed + 1) % 3)
        finals[sync] = tracker.compute_final_metrics(num_verts=60)
    for m in metrics:
        np.testing.assert_allclose(finals[3][m], finals[1][m], rtol=1e-6)
        pf = np.load(tmp_path / "3" / f"{m}_per_frame.npy")
        np.testing.assert_array_equal(pf, np.load(tmp_path / "1" / f"{m}_per_frame.npy"))
        assert pf.shape == (15,)
    assert "PVE-PA" in capsys.readouterr().out


def _write_ssp3d(root, n=3, orig=96):
    import cv2

    rng = np.random.default_rng(4)
    for sub in ("images", "silhouettes"):
        os.makedirs(os.path.join(root, sub))
    fnames = [f"im{i}.png" for i in range(n)]
    for i, name in enumerate(fnames):
        cv2.imwrite(os.path.join(root, "images", name), rng.integers(0, 255, (orig, orig + 10, 3)).astype(np.uint8))
        sil = np.zeros((orig, orig + 10), np.uint8)
        sil[20 + i : 70, 30:60] = 255
        cv2.imwrite(os.path.join(root, "silhouettes", name), sil)
    kp = rng.uniform(10, orig - 10, size=(n, 17, 3)).astype(np.float32)
    kp[:, :, 2] = rng.uniform(size=(n, 17))
    np.savez(
        os.path.join(root, "labels.npz"), fnames=np.array(fnames), shapes=rng.normal(size=(n, 10)),
        poses=rng.normal(scale=0.3, size=(n, 72)), joints2D=kp,
        bbox_centres=np.array([[48.0, 50.0], [40.0, 60.0], [10.0, 90.0]])[:n],
        bbox_whs=np.array([60.0, 80.0, 70.0])[:n], genders=np.array(["m", "f", "f"])[:n],
    )


def _write_pw3d(root, n=3, orig=64):
    import cv2

    rng = np.random.default_rng(5)
    os.makedirs(os.path.join(root, "cropped_frames"))
    for i in range(n):
        cv2.imwrite(os.path.join(root, "cropped_frames", f"f{i}.png"),
                    rng.integers(0, 255, (orig, orig, 3)).astype(np.uint8))
    kp = rng.uniform(4, orig - 4, size=(n, 17, 3)).astype(np.float32)
    kp[:, :, 2] = rng.uniform(size=(n, 17))
    np.save(os.path.join(root, "hrnet_results_centred.npy"), kp)
    j2d = rng.uniform(4, orig - 4, size=(n, 17, 3)).astype(np.float32)
    j2d[:, :, 2] = rng.uniform(size=(n, 17))
    np.savez(
        os.path.join(root, "3dpw_test.npz"), imgname=np.array([f"f{i}.png" for i in range(n)]),
        pose=rng.normal(scale=0.3, size=(n, 72)), shape=rng.normal(size=(n, 10)),
        gender=np.array(["m", "f", "m"])[:n], joints2D_coco=j2d,
    )


@pytest.mark.parametrize("which", ["ssp3d", "3dpw"])
def test_eval_datasets_match_jax(tmp_path, which):
    pytest.importorskip("cv2")
    jcfg, tcfg = jax_defaults(), torch_defaults()
    root = str(tmp_path / which)
    os.makedirs(root)
    if which == "ssp3d":
        _write_ssp3d(root)
        want_ds = jdata.SSP3DEvalDataset(root, jcfg, visible_joints_threshold=0.5)
        got_ds = tdata.SSP3DEvalDataset(root, tcfg, visible_joints_threshold=0.5)
    else:
        _write_pw3d(root)
        want_ds = jdata.PW3DEvalDataset(root, jcfg, visible_joints_threshold=0.5)
        got_ds = tdata.PW3DEvalDataset(root, tcfg, visible_joints_threshold=0.5)
    want = list(jdata.batch_iterator(want_ds, 2))
    got = list(tdata.batch_iterator(got_ds, 2))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            if isinstance(w[k], list):
                assert g[k] == w[k], k
            else:
                assert g[k].dtype == w[k].dtype, k
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    assert got[0]["image"].shape == (2, 256, 256, 3)


class _FakeEvalDataset:
    """Payload of the real eval datasets (uint8 image, keypoints, GT pose,
    shape and silhouette), made from numpy seeds."""

    def __init__(self, n=4, img=IMG):
        self.n, self.img = n, img

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        rng = np.random.default_rng(i)
        sil = np.zeros((self.img, self.img), np.uint8)
        sil[8:24, 10:22] = 1
        return {
            "pose": rng.normal(scale=0.3, size=72).astype(np.float32),
            "shape": rng.normal(scale=0.5, size=10).astype(np.float32),
            "joints2D": rng.uniform(0, self.img, size=(17, 2)).astype(np.float32),
            "joints2D_visib": rng.uniform(size=17) < 0.8,
            "fname": f"frame_{i:04d}.png",
            "gender": "f" if i % 2 else "m",
            "image": (rng.uniform(size=(self.img, self.img, 3)) * 255).astype(np.uint8),
            "input_joints2D": rng.uniform(0, self.img, size=(17, 2)).astype(np.int16).astype(np.float32),
            "input_joints2D_vis": np.ones(17, bool),
            "silhouette": sil,
        }


@pytest.fixture(scope="module")
def eval_pair():
    """JAX and port models on the same weights, the three SMPL models, the
    renderers, and the port's noise hook replaying the JAX key pool."""
    cfgs = []
    for cfg in (jax_defaults(), torch_defaults()):
        cfg.DATA = dataclasses.replace(cfg.DATA, PROXY_REP_SIZE=IMG)
        cfgs.append(cfg)
    jcfg, tcfg = cfgs
    jm = JaxModel(jcfg.MODEL)
    source = TorchModel(tcfg.MODEL, device="cpu", generator=torch.Generator().manual_seed(6))
    jparams = jax_params_from_port(source, jm, input_shape=(1, IMG, IMG, 18))
    tm = params_from_jax(jparams, TorchModel(tcfg.MODEL, device="cpu"))
    jsmpl = [j_synthetic_smpl(num_verts=6890, seed=s) for s in (0, 1, 2)]
    tsmpl = [t_synthetic_smpl(num_verts=6890, seed=s, device="cpu") for s in (0, 1, 2)]
    # evaluate_humaniflow's key pool: split(PRNGKey(0), 65), keys popped from the end
    pool = jax.random.split(jax.random.PRNGKey(0), 65)

    def noise_fn(i, b, n):
        shape, levels = jax_noise(jm, pool[64 - i], b, n)
        return t(shape.astype(np.float32)), [t(z) for z in levels]

    return (jm, jparams, jsmpl, jcfg), (tm, tsmpl, tcfg), noise_fn


@pytest.mark.parametrize("protocol", ["ssp3d", "3dpw"])
def test_evaluate_humaniflow_matches_jax(eval_pair, protocol, tmp_path):
    (jm, jparams, jsmpl, jcfg), (tm, tsmpl, tcfg), noise_fn = eval_pair
    metrics = list(EVAL_METRICS_SSP3D if protocol == "ssp3d" else EVAL_METRICS_3DPW)
    kw = dict(batch_size=B, num_pred_samples=N, save_per_frame_metrics=True)
    jr = tr = None
    if protocol == "ssp3d":
        jr = JaxRenderer(img_wh=IMG, projection_type="orthographic", render_rgb=False)
        tr = TorchRenderer(img_wh=IMG, render_rgb=False, device="cpu")
        kw["silhouette_sample_chunk"] = 2  # the chunked path with a remainder
    want = j_evaluate(jm, jparams, *jsmpl, jcfg, _FakeEvalDataset(), metrics, renderer=jr,
                      save_path=str(tmp_path / "jax"), **kw)
    times = []
    got = t_evaluate(tm, *tsmpl, tcfg, _FakeEvalDataset(), metrics, renderer=tr, noise_fn=noise_fn,
                     save_path=str(tmp_path / "port"), batch_times=times, device="cpu", **kw)
    assert len(times) == 2
    assert set(got) == set(want) == set(metrics)
    for m in metrics:
        assert np.isfinite(got[m]), m
        if "IOU" in m:
            assert 0.0 <= got[m] <= 1.0
            np.testing.assert_allclose(got[m], want[m], atol=IOU_ATOL, rtol=0, err_msg=m)
        else:
            np.testing.assert_allclose(got[m], want[m], rtol=METRIC_RTOL, atol=0, err_msg=m)
    for name in [f"{m}_per_frame" for m in metrics] + ["pose_per_frame", "shape_per_frame", "cam_per_frame"]:
        w = np.load(tmp_path / "jax" / f"{name}.npy")
        g = np.load(tmp_path / "port" / f"{name}.npy")
        assert g.shape == w.shape and g.shape[0] == 4, name
        if "IOU" in name:
            np.testing.assert_allclose(g, w, atol=IOU_ATOL, rtol=0, err_msg=name)
        else:
            assert rel_err(g, w) <= METRIC_RTOL, name
    np.testing.assert_array_equal(np.load(tmp_path / "port" / "fname_per_frame.npy"),
                                  np.load(tmp_path / "jax" / "fname_per_frame.npy"))
