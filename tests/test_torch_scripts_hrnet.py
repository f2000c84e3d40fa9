"""The port's HRNet keypoint generator (humaniflow_torch/cli/generate_hrnet_keypoints.py)
against scripts/generate_hrnet_keypoints.py on the CPU, with HRNet's input
shrunk on both sides and one fabricated reference `.pth`; its no-checkpoint
path; and the converter's weight flags (cli/convert_model_files.py)."""

import importlib
import os
import sys

import numpy as np
import pytest
import torch
from _torch_parity import _reference_humaniflow_state_dict, jax_params_from_port, random_hrnet_variables, small_cfgs
from test_torch_hrnet import _reference_hrnet_state_dict

from humaniflow_torch.cli import convert_model_files, generate_hrnet_keypoints
from humaniflow_torch.models import HumaniflowModel as TorchModel
from humaniflow_torch.models import PoseHighResolutionNet as TorchHRNet
from humaniflow_torch.utils.load_reference import load_hrnet_checkpoint, load_humaniflow_checkpoint
from humaniflow_tpu.models import HumaniflowModel as JaxModel
from humaniflow_tpu.models.hrnet import PoseHighResolutionNet as JaxHRNet

cv2 = pytest.importorskip("cv2")
# the modules by path: each package's `pipelines.predict_hrnet` is the function
jph = importlib.import_module("humaniflow_tpu.pipelines.predict_hrnet")
tph = importlib.import_module("humaniflow_torch.pipelines.predict_hrnet")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Keypoints: 1e-3 px of the frames' pixels (the argmax agrees; the scale
# factors are float32 on both sides).  Confidences: 1e-4 of the largest, as
# the heatmaps (tests/test_torch_hrnet.py).
HR_WH, HM_WH = (64, 96), (16, 24)  # HRNet input shrunk as tests/test_torch_predict_hrnet.py
KP_ATOL = 1e-3
CONF_RTOL = 1e-4
FRAME_SIDES = (80, 80, 60, 60)  # square crops of two sizes


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Cropped frames and a reference-layout HRNet `.pth` of seeded weights."""
    root = tmp_path_factory.mktemp("hrnet_keypoints")
    frames = root / "cropped_frames"
    os.makedirs(frames)
    rng = np.random.default_rng(11)
    for i, side in enumerate(FRAME_SIDES):
        img = cv2.resize(rng.integers(0, 256, (side // 8, side // 8, 3), dtype=np.uint8), (side, side))
        cv2.imwrite(str(frames / f"f{i}.png"), img)
    variables = random_hrnet_variables(JaxHRNet(), (1, HR_WH[1], HR_WH[0], 3), seed=5)
    pth = str(root / "pose_hrnet_w48_384x288.pth")
    torch.save(_reference_hrnet_state_dict(variables), pth)
    return root, str(frames), pth


def _shrink(mp):
    for mod in (jph, tph):
        mp.setattr(mod, "HRNET_INPUT_WH", HR_WH)
        mp.setattr(mod, "HRNET_HEATMAP_WH", HM_WH)


def test_keypoints_match_jax(files, monkeypatch):
    root, frames, pth = files
    _shrink(monkeypatch)
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    try:
        script = importlib.import_module("generate_hrnet_keypoints")
    finally:
        sys.path.remove(os.path.join(REPO, "scripts"))
    argv = ["--frames_dir", frames, "--hrnet_checkpoint", pth, "--batch_size", "2"]
    monkeypatch.setattr(sys, "argv", ["generate_hrnet_keypoints.py", *argv, "--out_path", str(root / "jax.npy")])
    script.main()
    got = generate_hrnet_keypoints.main([*argv, "--out_path", str(root / "port.npy"), "--device", "cpu"])
    want = np.load(root / "jax.npy")
    np.testing.assert_array_equal(np.load(root / "port.npy"), got)
    assert got.shape == want.shape == (len(FRAME_SIDES), 17, 3) and got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got[..., :2], want[..., :2], atol=KP_ATOL, rtol=0)
    np.testing.assert_allclose(got[..., 2], want[..., 2], atol=CONF_RTOL * np.abs(want[..., 2]).max(), rtol=0)
    # keypoints in the frames' pixels: the larger frames' reach past the smaller frames' side
    assert got[:2, :, :2].max() > FRAME_SIDES[2] and got[2:, :, :2].max() < FRAME_SIDES[2]


def test_without_a_checkpoint_warns_and_writes_finite_keypoints(files, monkeypatch, capsys):
    root, frames, _ = files
    _shrink(monkeypatch)
    out = str(root / "random.npy")
    got = generate_hrnet_keypoints.main(["--frames_dir", frames, "--out_path", out, "--device", "cpu"])
    assert "WARNING: no HRNet checkpoint" in capsys.readouterr().out
    saved = np.load(out)
    assert saved.shape == (len(FRAME_SIDES), 17, 3) and saved.dtype == np.float32 and np.isfinite(saved).all()
    np.testing.assert_array_equal(saved, got)


def test_convert_model_files_writes_the_ports_checkpoints(files, tmp_path):
    """--humaniflow_tar and --hrnet_pth write {"params": state_dict} files
    that load to the same tensors as the `.tar` and `.pth` they came from."""
    _, _, pth = files
    jcfg, tcfg = small_cfgs(18)
    jm = JaxModel(jcfg.MODEL)
    source = TorchModel(tcfg.MODEL, device="cpu", generator=torch.Generator().manual_seed(3))
    tar = str(tmp_path / "humaniflow_weights.tar")
    torch.save({"best_model_state_dict": _reference_humaniflow_state_dict(jax_params_from_port(source, jm), jm)}, tar)
    out = convert_model_files.main(["--humaniflow_tar", tar, "--hrnet_pth", pth, "--out_dir", str(tmp_path / "conv")])
    assert out == {"humaniflow": str(tmp_path / "conv" / "humaniflow_params.pt"),
                   "hrnet": str(tmp_path / "conv" / "hrnet_params.pt")}
    assert sorted(torch.load(out["hrnet"], weights_only=False)) == ["params"]
    pairs = (
        (load_humaniflow_checkpoint, lambda: TorchModel(tcfg.MODEL, device="cpu"), tar, out["humaniflow"]),
        (load_hrnet_checkpoint, lambda: TorchHRNet(device="cpu"), pth, out["hrnet"]),
    )
    for load, fresh, reference, converted in pairs:
        want, got = load(reference, fresh()).state_dict(), load(converted, fresh()).state_dict()
        assert sorted(got) == sorted(want)
        for k in want:
            if not k.endswith("num_batches_tracked"):
                torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)
