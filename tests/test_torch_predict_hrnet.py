"""The port's uncropped-image predict path against humaniflow_tpu on the CPU:
the crop ops, the keypoint-box helpers, the HRNet stage, the whole slice
(uncropped images → HRNet keypoints → proxy crop → predict with the fused
flow level on both sides), the reference `.tar` loader, the predict CLI,
and the port's own training checkpoints through the predict and optimise
CLIs."""

import dataclasses
import importlib
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import (
    _reference_humaniflow_state_dict,
    jax_noise,
    jax_params_from_port,
    random_hrnet_variables,
    small_cfgs,
    t,
)

from humaniflow_torch.data import image_ops as tops
from humaniflow_torch.models import HumaniflowModel as TorchModel
from humaniflow_torch.models import PoseHighResolutionNet as TorchHRNet
from humaniflow_torch.models import smpl as tsmpl
from humaniflow_torch.pipelines import predict as tpredict
from humaniflow_torch.utils.convert_jax import hrnet_params_from_jax, params_from_jax
from humaniflow_torch.utils.load_reference import (
    humaniflow_state_from_reference,
    load_humaniflow_checkpoint,
    load_torch_state_dict,
)
from humaniflow_tpu.data import image_ops as jops
from humaniflow_tpu.models import HumaniflowModel as JaxModel
from humaniflow_tpu.models import synthetic_smpl as j_synthetic_smpl
from humaniflow_tpu.models.hrnet import PoseHighResolutionNet as JaxHRNet
from humaniflow_tpu.pipelines import predict as jpredict
from humaniflow_tpu.utils.convert_torch import convert_humaniflow_checkpoint

jph = importlib.import_module("humaniflow_tpu.pipelines.predict_hrnet")
# the modules by path: each package's `pipelines.predict_hrnet` is the function
tph = importlib.import_module("humaniflow_torch.pipelines.predict_hrnet")

# Crops and boxes: 1e-5 (float32 resampling matmuls in other orders).  The
# slice: 5e-4, as the predict slice (docs/PARITY.md).  The proxy's thin-edge
# channel: at most 0.1% of pixels may differ at orientation ties, as in
# tests/test_torch_predict.py.
CROP_ATOL = 1e-5
SLICE_ATOL = 5e-4
EDGE_TIE_FRACTION = 1e-3
HR_WH, HM_WH = (64, 96), (16, 24)  # HRNet input shrunk as tests/test_predict_hrnet.py
PROXY = 32
N = 3


def _uncropped(h, w, cy, cx, seed, r=18):
    rng = np.random.default_rng(seed)
    img = 0.1 + 0.05 * rng.normal(size=(h, w, 3))
    img[max(cy - 2 * r, 0):cy + 2 * r, max(cx - r, 0):cx + r] += 0.7
    return np.clip(img, 0, 1).astype(np.float32)


def test_bbox_helpers_match_jax():
    rng = np.random.default_rng(0)
    seg = np.zeros((2, 40, 30), np.float32)
    seg[0, 5:20, 7:25] = 1
    seg[1, 30:38, 2:4] = 2
    np.testing.assert_array_equal(tops.bbox_from_silhouette(t(seg)).numpy(),
                                  np.asarray(jops.bbox_from_silhouette(jnp.asarray(seg))))
    j2d = rng.uniform(0, 50, size=(2, 17, 2)).astype(np.float32)
    vis = rng.uniform(size=(2, 17)) > 0.3
    np.testing.assert_array_equal(tops.bbox_from_joints2d(t(j2d), t(vis)).numpy(),
                                  np.asarray(jops.bbox_from_joints2d(jnp.asarray(j2d), jnp.asarray(vis))))
    corners = rng.uniform(0, 100, size=(3, 4)).astype(np.float32)
    for got, want in zip(tops.convert_bbox_corners_to_centre_hw(t(corners)),
                         jops.convert_bbox_corners_to_centre_hw(jnp.asarray(corners))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=CROP_ATOL, rtol=0)
    c, h, w = (rng.uniform(10, 50, size=s).astype(np.float32) for s in ((3, 2), (3,), (3,)))
    np.testing.assert_allclose(tops.convert_bbox_centre_hw_to_corners(t(c), t(h), t(w)).numpy(),
                               np.asarray(jops.convert_bbox_centre_hw_to_corners(c, h, w)), atol=CROP_ATOL, rtol=0)


@pytest.mark.parametrize("source", ["boxes", "seg", "joints"])
def test_batch_crop_affine_matches_jax(source):
    """RGB bilinear, seg and IUV nearest (IUV with an out-of-frame pad) and the
    joints, around given boxes, silhouette boxes or visible-joint boxes."""
    rng = np.random.default_rng(1)
    b, h, w = 2, 50, 40
    rgb = rng.uniform(size=(b, h, w, 3)).astype(np.float32)
    seg = np.zeros((b, h, w), np.float32)
    seg[0, 10:40, 8:30] = 1
    seg[1, 3:20, 20:38] = 1
    iuv = rng.integers(0, 25, size=(b, h, w, 3)).astype(np.float32)
    j2d = rng.uniform(5, 35, size=(b, 17, 2)).astype(np.float32)
    vis = np.ones((b, 17), bool)
    kw, pad = dict(rgb=rgb, seg=seg, joints2d=j2d), {}
    if source == "boxes":
        kw.update(bbox_centres=np.array([[25, 20], [12, 30]], np.float32), bbox_heights=np.array([30, 18], np.float32),
                  bbox_widths=np.array([20, 25], np.float32), iuv=iuv)
        pad = {"out_of_frame_pad_val": -1.0}
    elif source == "seg":
        kw.update(iuv=iuv)
    else:
        kw.update(joints2d_vis=vis)
    want = jops.batch_crop_affine((24, 32), **{k: jnp.asarray(v) for k, v in kw.items()}, **pad)
    got = tops.batch_crop_affine((24, 32), **{k: t(v) for k, v in kw.items()}, **pad)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=CROP_ATOL, rtol=0, err_msg=k)


def test_keypoint_box_helpers_match_jax():
    """The two-person cases of tests/test_predict_hrnet.py: the central
    cluster and the box of its confident keypoints, equal to JAX's."""
    rng = np.random.default_rng(0)
    cases = [
        (np.concatenate([250.0 + rng.uniform(-40, 40, size=(11, 2)), 60.0 + rng.uniform(-25, 25, size=(6, 2))]),
         np.where(np.arange(17) == 3, 0.1, 0.9)),
        (np.concatenate([250.0 + rng.uniform(-30, 30, size=(8, 2)), 40.0 + rng.uniform(-20, 20, size=(8, 2)),
                         [[499.0, 499.0]]]), np.where(np.arange(17) == 16, 0.0, 0.9)),
        (250.0 + rng.uniform(-60, 60, size=(17, 2)), np.full(17, 0.9)),
    ]
    for j2d, confs in cases:
        j2d, confs = j2d.astype(np.float32), confs.astype(np.float32)
        got = tph.select_central_keypoint_cluster(j2d, confs, 500, 500)
        want = jph.select_central_keypoint_cluster(j2d, confs, 500, 500)
        np.testing.assert_array_equal(got, want)
        kept = np.where(got, confs, 0.0)
        (gc, gh, gw), (wc, wh, ww) = tph.bbox_from_keypoints(j2d, kept), jph.bbox_from_keypoints(j2d, kept)
        np.testing.assert_array_equal(gc, wc)
        assert (gh, gw) == (wh, ww)
    assert tph.bbox_from_keypoints(j2d, np.zeros(17, np.float32)) is None


class _BlobHRNet(torch.nn.Module):
    """Heatmaps that peak around the brightest region (17 shifted copies of
    the 4×-pooled brightness), as the fake of tests/test_predict_hrnet.py."""

    OFFSETS = [(dy, dx) for dy in (-2, 0, 2) for dx in (-2, 0, 2)] + [
        (dy, dx) for dy in (-4, 4) for dx in (-4, 0, 4)] + [(0, -4), (0, 4)]

    device = torch.device("cpu")

    def forward(self, x):
        img = torch.nn.functional.avg_pool2d(x.mean(-1)[:, None], 4)[:, 0]
        return torch.stack([torch.roll(img, (dy, dx), dims=(1, 2)) for dy, dx in self.OFFSETS], dim=-1)


def test_keypoint_box_fallback_recentres_on_the_person():
    img = _uncropped(400, 320, 280, 90, seed=0, r=15)
    out = tph.predict_hrnet_batch(_BlobHRNet(), [img], device="cpu")
    c = out["bbox_centres"][0]
    assert abs(c[0] - 280) < 60 and abs(c[1] - 90) < 60 and out["bbox_heights"][0] < 400
    assert out["cropped_images"].shape == (1, 384, 288, 3) and out["joints2D"].shape == (1, 17, 2)
    off = tph.predict_hrnet_batch(_BlobHRNet(), [img], keypoint_bbox_fallback=False, device="cpu")
    np.testing.assert_allclose(off["bbox_centres"][0], [200, 160])
    single = tph.predict_hrnet(_BlobHRNet(), img, device="cpu")
    np.testing.assert_array_equal(single["joints2D"].numpy(), out["joints2D"][0].numpy())


def test_torchvision_adapter_with_a_fake_backend(monkeypatch):
    """torchvision is not installed here: a fake Mask-RCNN with two confident
    persons, one unconfident and one non-person; the centre-most confident
    person wins, and no confident person gives None."""
    h, w = 200, 160
    pred = {"boxes": torch.tensor([[10.0, 10.0, 50.0, 90.0], [60.0, 40.0, 120.0, 180.0],
                                   [70.0, 50.0, 110.0, 170.0], [65.0, 45.0, 115.0, 175.0]]),
            "labels": torch.tensor([1, 1, 1, 2]), "scores": torch.tensor([0.99, 0.97, 0.50, 0.99])}
    detection = types.ModuleType("torchvision.models.detection")
    detection.maskrcnn_resnet50_fpn = lambda pretrained=True: _FakeMaskRCNN(pred)
    models_mod = types.ModuleType("torchvision.models")
    models_mod.detection = detection
    tv = types.ModuleType("torchvision")
    tv.models = models_mod
    monkeypatch.setitem(sys.modules, "torchvision", tv)
    monkeypatch.setitem(sys.modules, "torchvision.models", models_mod)
    monkeypatch.setitem(sys.modules, "torchvision.models.detection", detection)
    centre, height, width = tph.detect_person_bbox_torchvision(np.zeros((h, w, 3), np.float32), threshold=0.95)
    np.testing.assert_allclose(centre, [110.0, 90.0])
    assert (height, width) == (140.0, 60.0)
    pred["scores"] = torch.tensor([0.5, 0.5, 0.5, 0.99])
    assert tph.detect_person_bbox_torchvision(np.zeros((h, w, 3), np.float32), threshold=0.95) is None


class _FakeMaskRCNN:
    def __init__(self, pred):
        self.pred = pred

    def eval(self):
        return self

    def __call__(self, images):
        return [self.pred]


@pytest.fixture(scope="module")
def slice_models():
    """JAX and port HuManiFlow (32² proxy) and HRNet on the same weights."""
    jcfg, tcfg = small_cfgs()
    jcfg.DATA = dataclasses.replace(jcfg.DATA, PROXY_REP_SIZE=PROXY)
    tcfg.DATA = dataclasses.replace(tcfg.DATA, PROXY_REP_SIZE=PROXY)
    jm = JaxModel(jcfg.MODEL)
    source = TorchModel(tcfg.MODEL, device="cpu", generator=torch.Generator().manual_seed(8))
    jparams = jax_params_from_port(source, jm, input_shape=(1, PROXY, PROXY, 18))
    tm = params_from_jax(jparams, TorchModel(tcfg.MODEL, device="cpu"))
    variables = random_hrnet_variables(JaxHRNet(), (1, HR_WH[1], HR_WH[0], 3), seed=5)
    thr = hrnet_params_from_jax(variables, TorchHRNet(device="cpu"))
    return (jm, jparams, jcfg, JaxHRNet(), variables), (tm, tcfg, thr)


def test_uncropped_predict_slice_matches_jax(slice_models, monkeypatch, capsys):
    """Two uncropped images of different sizes → predict_hrnet_batch (with
    the keypoint-box fallback) → the square crop to a 32² proxy →
    predict_humaniflow with HFT_FUSED_LEVEL=1, N=3, JAX against the port with
    the same weights and noise.  JAX's boxes and keypoints feed the port's
    later stages, so that an argmax flipped on a random net cannot cascade."""
    (jm, jparams, jcfg, jhr, variables), (tm, tcfg, thr) = slice_models
    for mod in (jph, tph):
        monkeypatch.setattr(mod, "HRNET_INPUT_WH", HR_WH)
        monkeypatch.setattr(mod, "HRNET_HEATMAP_WH", HM_WH)
    monkeypatch.setenv("HFT_FUSED_LEVEL", "1")
    images = [_uncropped(120, 100, 70, 40, seed=1), _uncropped(90, 140, 45, 90, seed=2)]

    want = jph.predict_hrnet_batch(jhr, variables, images)
    got = tph.predict_hrnet_batch(thr, images, device="cpu")
    free_diff = int((np.abs(got["joints2D"].numpy() - want["joints2D"]) > 0).any(-1).sum())
    boxes = [(want["bbox_centres"][i], want["bbox_heights"][i], want["bbox_widths"][i]) for i in range(2)]
    pinned = tph.predict_hrnet_batch(thr, images, bboxes=boxes, keypoint_bbox_fallback=False, device="cpu")
    np.testing.assert_allclose(pinned["cropped_images"].numpy(), want["cropped_images"], atol=CROP_ATOL, rtol=0)
    pinned_diff = int((np.abs(pinned["joints2D"].numpy() - want["joints2D"]) > 0).any(-1).sum())
    with capsys.disabled():
        print(f"\nHRNet keypoints differing from JAX (of 34): {free_diff} with the port's own fallback boxes, "
              f"{pinned_diff} on JAX's boxes")
    assert got["joints2D"].shape == (2, 17, 2) and got["cropped_images"].shape == (2, HR_WH[1], HR_WH[0], 3)

    side = float(max(HR_WH))
    box = dict(orig_scale_factor=1.0)
    jcrop = jops.batch_crop_affine(
        (PROXY, PROXY), rgb=jnp.asarray(want["cropped_images"]), joints2d=jnp.asarray(want["joints2D"]),
        bbox_centres=jnp.tile(jnp.asarray([[HR_WH[1] / 2.0, HR_WH[0] / 2.0]]), (2, 1)),
        bbox_heights=jnp.full((2,), side), bbox_widths=jnp.full((2,), side), **box)
    tcrop = tops.batch_crop_affine(
        (PROXY, PROXY), rgb=pinned["cropped_images"], joints2d=t(want["joints2D"]),
        bbox_centres=torch.tensor([[HR_WH[1] / 2.0, HR_WH[0] / 2.0]]).expand(2, 2),
        bbox_heights=torch.full((2,), side), bbox_widths=torch.full((2,), side), **box)
    for k in ("rgb", "joints2d"):
        np.testing.assert_allclose(tcrop[k].numpy(), np.asarray(jcrop[k]), atol=CROP_ATOL, rtol=0, err_msg=k)

    key = jax.random.PRNGKey(4)
    jsmpl = j_synthetic_smpl(num_verts=128)
    tsm = tsmpl.synthetic_smpl(num_verts=128, device="cpu")
    jw = jpredict.predict_humaniflow(jm, jparams, jsmpl, jcfg, np.asarray(jcrop["rgb"]), np.asarray(jcrop["joints2d"]),
                                     want["joints2Dconfs"], num_samples=N, key=key)
    _, levels = jax_noise(jm, key, 2, N)
    tw = tpredict.predict_humaniflow(tm, tsm, tcfg, tcrop["rgb"], t(np.asarray(jcrop["joints2d"])),
                                     t(want["joints2Dconfs"]), num_samples=N, device="cpu",
                                     base_noise=[t(z) for z in levels])
    assert set(tw) == set(jw)
    proxy, want_proxy = tw["proxy_rep"].numpy(), np.asarray(jw["proxy_rep"])
    assert float(np.mean(np.abs(proxy[..., 0] - want_proxy[..., 0]) > CROP_ATOL)) <= EDGE_TIE_FRACTION
    np.testing.assert_allclose(proxy[..., 1:], want_proxy[..., 1:], atol=CROP_ATOL, rtol=0)
    for k in jw:
        if k != "proxy_rep":
            np.testing.assert_allclose(tw[k].numpy(), np.asarray(jw[k]), atol=SLICE_ATOL, rtol=0, err_msg=k)


def test_load_humaniflow_checkpoint_matches_the_jax_converter(slice_models, tmp_path):
    """A `.tar` in the reference's training-checkpoint layout, with the true
    weights under best_model_state_dict beside a perturbed
    model_state_dict: the port loaded from it equals the JAX converter's
    output carried across; a missing or an extra tensor raises."""
    (jm, jparams, jcfg, _, _), (_, tcfg, _) = slice_models
    best = _reference_humaniflow_state_dict(jparams, jm)
    path = str(tmp_path / "humaniflow_weights.tar")
    torch.save({"epoch": 5, "best_epoch": 4, "best_epoch_val_metrics": {"PVE-SC": 0.0712},
                "model_state_dict": _reference_humaniflow_state_dict(jparams, jm, scale=1.5),
                "best_model_state_dict": best, "optimiser_state_dict": {}}, path)
    got = load_humaniflow_checkpoint(path, TorchModel(tcfg.MODEL, device="cpu"))
    converted = convert_humaniflow_checkpoint({k: v.numpy() for k, v in load_torch_state_dict(path).items()}, jm)
    want = params_from_jax(converted, TorchModel(tcfg.MODEL, device="cpu"))
    got_sd, want_sd = got.state_dict(), want.state_dict()
    for k in want_sd:
        if not k.endswith("num_batches_tracked"):
            torch.testing.assert_close(got_sd[k], want_sd[k], rtol=0, atol=0, msg=k)
    assert float(got_sd["fc_flow_context_weight"][0, :, jm.isgc_dim:].abs().max()) == 0.0  # part 0: no ancestors

    fresh = TorchModel(tcfg.MODEL, device="cpu")
    broken = dict(best)
    del broken["pose_so3flow_transform_modules.45.nn.layers.3.bias"]
    with pytest.raises(KeyError, match="pose_so3flow_transform_modules.45.nn.layers.3.bias"):
        humaniflow_state_from_reference(broken, fresh)
    with pytest.raises(KeyError, match="image_encoder.fc.weight"):
        humaniflow_state_from_reference({**best, "image_encoder.fc.weight": torch.zeros(2)}, fresh)


def _cli_files(slice_models, tmp_path, monkeypatch):
    """Fabricated CLI inputs under tmp_path: SMPL files in a temporary
    model-files directory, the reference's `.tar` and `.pth` holding the
    slice's weights, two tiny PNGs and a 32²-proxy config; returns
    (the .tar, the .pth, the image directory, the config)."""
    import cv2

    from humaniflow_torch.configs import paths
    from humaniflow_torch.utils.load_reference import _hrnet_reference_name

    (jm, jparams, _, _, _), (_, _, thr) = slice_models
    monkeypatch.setattr(tph, "HRNET_INPUT_WH", HR_WH)
    monkeypatch.setattr(tph, "HRNET_HEATMAP_WH", HM_WH)
    files = tmp_path / "model_files"
    (files / "smpl").mkdir(parents=True)
    smpl = tsmpl.synthetic_smpl(num_verts=6890, device="cpu")
    np.savez(files / "smpl" / "SMPL_NEUTRAL.npz", v_template=smpl.v_template.numpy(),
             shapedirs=smpl.shapedirs.numpy(), posedirs=smpl.posedirs.numpy(), J_regressor=smpl.j_regressor.numpy(),
             weights=smpl.lbs_weights.numpy(), f=smpl.faces.numpy())
    monkeypatch.setattr(paths, "SMPL_NEUTRAL", str(files / "smpl" / "SMPL_NEUTRAL.npz"))
    for name in ("J_REGRESSOR_EXTRA", "COCOPLUS_REGRESSOR", "H36M_REGRESSOR"):
        monkeypatch.setattr(paths, name, str(files / f"{name.lower()}.npy"))  # absent: skipped
    tar = str(files / "humaniflow_weights.tar")
    torch.save({"best_model_state_dict": _reference_humaniflow_state_dict(jparams, jm)}, tar)
    pth = str(files / "pose_hrnet_w48_384x288.pth")
    torch.save({f"{_hrnet_reference_name(k.rsplit('.', 1)[0])}.{k.rsplit('.', 1)[1]}": v
                for k, v in thr.state_dict().items()}, pth)

    img_dir = tmp_path / "images"
    img_dir.mkdir()
    rng = np.random.default_rng(6)
    for name, (h, w) in (("a.png", (48, 40)), ("b.png", (36, 52))):
        cv2.imwrite(str(img_dir / name), rng.integers(0, 255, size=(h, w, 3)).astype(np.uint8))
    cfg = tmp_path / "small.yaml"
    cfg.write_text(f"DATA:\n  PROXY_REP_SIZE: {PROXY}\n")
    return tar, pth, img_dir, cfg


def test_predict_cli_writes_predictions(slice_models, tmp_path, monkeypatch):
    """`python -m humaniflow_torch.cli.run_predict` on two tiny PNGs, with
    fabricated checkpoints and SMPL files under a temporary model-files
    directory, on the CPU: one prediction .npz per image."""
    from humaniflow_torch.cli import run_predict

    tar, pth, img_dir, cfg = _cli_files(slice_models, tmp_path, monkeypatch)
    out_dir = tmp_path / "out"
    run_predict.main(["-I", str(img_dir), "-S", str(out_dir), "-C", tar, "--hrnet_checkpoint", pth,
                      "--hrnet_dtype", "f32", "-N", "2", "--cfg", str(cfg), "--device", "cpu"])
    assert sorted(os.listdir(out_dir)) == ["a_pred.npz", "b_pred.npz"]
    for name in ("a_pred.npz", "b_pred.npz"):
        d = np.load(out_dir / name)
        assert d["pose_rotmats_point_est"].shape == (23, 3, 3) and d["proxy_rep"].shape == (PROXY, PROXY, 18)
        assert d["cropped_image"].shape == (PROXY, PROXY, 3) and d["hrnet_joints2D"].shape == (17, 2)
        for k in d.files:
            assert np.isfinite(d[k]).all(), k


def test_predict_cli_writes_the_span_summary(slice_models, tmp_path, monkeypatch):
    """`run_predict --trace_spans PATH` on the CLI's tiny files: PATH holds
    the summary of the program's spans, the prediction's among them, and
    tracing is off again after the run."""
    import json

    from humaniflow_torch.cli import run_predict
    from humaniflow_torch.utils import tracing

    tar, pth, img_dir, cfg = _cli_files(slice_models, tmp_path, monkeypatch)
    spans = tmp_path / "spans.json"
    run_predict.main(["-I", str(img_dir), "-S", str(tmp_path / "out"), "-C", tar, "--hrnet_checkpoint", pth,
                      "--hrnet_dtype", "f32", "-N", "2", "--cfg", str(cfg), "--device", "cpu",
                      "--trace_spans", str(spans)])
    summary = json.loads(spans.read_text())
    for name in ("predict", "dist_infer", "flow.sample", "hrnet"):
        assert summary[name]["calls"] == 1 and summary[name]["host_s"] > 0, name
    assert summary["flow.level"]["calls"] == 8
    assert 0 <= summary["predict"]["self_s"] <= summary["predict"]["host_s"]
    assert not tracing.enabled()


def _train_checkpoint(save_dir, best, params):
    """A checkpoint in train_humaniflow's layout (pipelines/train.py), saved
    through utils/checkpoints.save_checkpoint; returns its path."""
    from humaniflow_torch.utils.checkpoints import save_checkpoint

    state = {"epoch": 2, "best_epoch": 1, "best_epoch_val_metrics": {"PVE-SC": 0.0712}, "params": params,
             "opt_state": {"state": {}, "param_groups": []}}
    if best is not None:
        state["best_params"] = best
    return save_checkpoint(str(save_dir), "epoch_000002", state)


def test_load_humaniflow_checkpoint_takes_the_ports_own_checkpoints(slice_models, tmp_path):
    """A checkpoint that train_humaniflow writes loads as its best_params
    (else its params), tensor for tensor, and predicts as the model it was
    taken from, here the model loaded from a reference `.tar`, which still
    loads; a port checkpoint with a tensor too many raises."""
    (jm, jparams, _, _, _), (_, tcfg, _) = slice_models
    ref_tar = str(tmp_path / "humaniflow_weights.tar")
    torch.save({"best_model_state_dict": _reference_humaniflow_state_dict(jparams, jm)}, ref_tar)
    tm = load_humaniflow_checkpoint(ref_tar, TorchModel(tcfg.MODEL, device="cpu"))
    best = tm.state_dict()
    perturbed = {k: v * 1.5 if v.is_floating_point() else v for k, v in best.items()}
    proxy = torch.from_numpy(np.random.default_rng(4).uniform(size=(2, PROXY, PROXY, 18)).astype(np.float32))

    def predict(model):
        with torch.no_grad():
            return model.apply(proxy, num_samples=2, generator=torch.Generator().manual_seed(5))

    want = predict(tm)
    cases = {"best_params": _train_checkpoint(tmp_path / "a", best, perturbed),
             "params": _train_checkpoint(tmp_path / "b", None, best), "reference .tar": ref_tar}
    for name, path in cases.items():
        got = load_humaniflow_checkpoint(path, TorchModel(tcfg.MODEL, device="cpu"))
        for k, v in best.items():
            torch.testing.assert_close(got.state_dict()[k], v, rtol=0, atol=0, msg=f"{name}: {k}")
        out = predict(got)
        for k in want:
            torch.testing.assert_close(out[k], want[k], rtol=0, atol=0, msg=f"{name}: {k}")

    extra = _train_checkpoint(tmp_path / "c", {**best, "fc9.weight": torch.zeros(2)}, best)
    with pytest.raises(KeyError, match="fc9.weight"):
        load_humaniflow_checkpoint(extra, TorchModel(tcfg.MODEL, device="cpu"))


def test_predict_and_optimise_clis_take_a_checkpoint_of_train_humaniflow(slice_models, tmp_path, monkeypatch):
    """The predict and optimise CLIs' -C, on the CPU: a train_humaniflow
    checkpoint holding the slice's weights (best_params; perturbed params)
    gives the same predictions and the same refined fits as the reference
    `.tar` of those weights."""
    from humaniflow_torch.cli import run_optimise, run_predict

    tar, pth, img_dir, cfg = _cli_files(slice_models, tmp_path, monkeypatch)
    best = load_humaniflow_checkpoint(tar, TorchModel(slice_models[1][1].MODEL, device="cpu")).state_dict()
    port = _train_checkpoint(tmp_path / "experiment", best,
                             {k: v * 1.5 if v.is_floating_point() else v for k, v in best.items()})
    opt_cfg = tmp_path / "opt.yaml"
    opt_cfg.write_text("NUM_ITERS: 3\n")
    outs = {}
    for name, ckpt in (("tar", tar), ("port", port)):
        pred_dir, opt_dir = tmp_path / f"pred_{name}", tmp_path / f"opt_{name}"
        torch.manual_seed(0)  # the same sample noise for both checkpoints
        run_predict.main(["-I", str(img_dir), "-S", str(pred_dir), "-C", ckpt, "--hrnet_checkpoint", pth,
                          "--hrnet_dtype", "f32", "-N", "2", "--cfg", str(cfg), "--device", "cpu"])
        run_optimise.main(["-I", str(img_dir), "-P", str(pred_dir), "-S", str(opt_dir), "-C", ckpt,
                           "--cfg", str(cfg), "--optimise_cfg", str(opt_cfg), "--no_visualise", "--device", "cpu"])
        outs[name] = {f: dict(np.load(d / f)) for d in (pred_dir, opt_dir) for f in os.listdir(d)}
    assert sorted(outs["port"]) == sorted(outs["tar"]) and len(outs["tar"]) == 4
    for f, arrays in outs["tar"].items():
        got = outs["port"][f]
        assert sorted(got) == sorted(arrays), f
        for k, v in arrays.items():
            np.testing.assert_array_equal(got[k], v, err_msg=f"{f}: {k}")
