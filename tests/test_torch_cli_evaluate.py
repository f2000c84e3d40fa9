"""The evaluate CLI against the JAX package's on the CPU: the reference's
`.tar` and fabricated 3DPW and SSP-3D directories go through
scripts/run_evaluate.py and `python -m humaniflow_torch.cli.run_evaluate`,
with SMPL files written by the port's converter and the JAX key pool as
the port's noise, and the per-frame metric files agree.  A checkpoint of
the port's own training loads through -C too."""

import dataclasses
import importlib
import os
import sys

import jax
import numpy as np
import pytest
import torch
from _torch_parity import _reference_humaniflow_state_dict, jax_noise, jax_params_from_port, rel_err, small_cfgs, t
from test_torch_train_data import write_smpl_pickle

from humaniflow_torch.cli import run_evaluate
from humaniflow_torch.configs import paths as tpaths
from humaniflow_torch.models import HumaniflowModel as TorchModel
from humaniflow_torch.models.smpl import convert_smpl_pkl
from humaniflow_torch.pipelines import evaluate as tevaluate
from humaniflow_torch.utils.checkpoints import save_checkpoint
from humaniflow_tpu.configs import paths as jpaths
from humaniflow_tpu.models import HumaniflowModel as JaxModel

cv2 = pytest.importorskip("cv2")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Per-frame metrics: rel 2e-4, the two IOU metrics abs 2e-2 (as
# tests/test_torch_eval.py: one pixel is ~1% of a small silhouette).
METRIC_RTOL = 2e-4
IOU_ATOL = 2e-2
IMG = 32
N_FRAMES, B, N = 4, 2, 3


def _build_ssp3d_dir(root, n=N_FRAMES, orig=64):
    """images/, silhouettes/ and labels.npz as the SSP-3D release lays them out."""
    rng = np.random.default_rng(12)
    for sub in ("images", "silhouettes"):
        os.makedirs(os.path.join(root, sub))
    for i in range(n):
        cv2.imwrite(os.path.join(root, "images", f"s{i}.png"), rng.integers(0, 255, (orig, orig, 3)).astype(np.uint8))
        sil = np.zeros((orig, orig), np.uint8)
        sil[12 + i:50, 20:44 - i] = 255
        cv2.imwrite(os.path.join(root, "silhouettes", f"s{i}.png"), sil)
    j2d = rng.uniform(4, orig - 4, size=(n, 17, 3)).astype(np.float32)
    j2d[:, :, 2] = rng.uniform(0.5, 1.0, size=(n, 17))
    np.savez(os.path.join(root, "labels.npz"), fnames=np.array([f"s{i}.png" for i in range(n)]),
             shapes=rng.normal(scale=0.5, size=(n, 10)).astype(np.float32),
             poses=rng.normal(scale=0.3, size=(n, 72)).astype(np.float32), joints2D=j2d,
             bbox_centres=np.full((n, 2), orig / 2, np.float32), bbox_whs=np.full((n,), orig * 0.8, np.float32),
             genders=np.array(["m", "f"] * (n // 2)))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The reference .tar (best_model_state_dict; a perturbed
    model_state_dict), SMPL .npz files from the port's converter, a 32²
    config and the two datasets; and the JAX model for the key pool."""
    from test_evaluate import _build_pw3d_dir

    root = tmp_path_factory.mktemp("cli_evaluate")
    jcfg, tcfg = small_cfgs(18)
    tcfg.DATA = dataclasses.replace(tcfg.DATA, PROXY_REP_SIZE=IMG)
    jm = JaxModel(jcfg.MODEL)
    source = TorchModel(tcfg.MODEL, device="cpu", generator=torch.Generator().manual_seed(6))
    jparams = jax_params_from_port(source, jm, input_shape=(1, IMG, IMG, 18))
    tar = str(root / "humaniflow_weights.tar")
    torch.save({"best_model_state_dict": _reference_humaniflow_state_dict(jparams, jm),
                "model_state_dict": _reference_humaniflow_state_dict(jparams, jm, scale=1.5)}, tar)
    smpl = {}
    for seed, gender in enumerate(("NEUTRAL", "MALE", "FEMALE")):
        pkl = root / f"SMPL_{gender}.pkl"
        write_smpl_pickle(pkl, seed=seed)
        smpl[gender] = str(root / f"SMPL_{gender}.npz")
        convert_smpl_pkl(str(pkl), smpl[gender])
    cfg = root / "small.yaml"
    cfg.write_text(f"DATA:\n  PROXY_REP_SIZE: {IMG}\n")
    pw3d, ssp3d = str(root / "3dpw"), str(root / "ssp3d")
    os.makedirs(pw3d)
    _build_pw3d_dir(pw3d, n=N_FRAMES)
    _build_ssp3d_dir(ssp3d)
    return dict(tar=tar, smpl=smpl, cfg=str(cfg), pw3d=pw3d, ssp3d=ssp3d, jm=jm, tcfg=tcfg, root=root)


def _point_paths(monkeypatch, files):
    for p in (jpaths, tpaths):
        for gender, path in files["smpl"].items():
            monkeypatch.setattr(p, f"SMPL_{gender}", path)
        monkeypatch.setattr(p, "PW3D_PATH", files["pw3d"])
        monkeypatch.setattr(p, "SSP3D_PATH", files["ssp3d"])


def _with_jax_noise(monkeypatch, jm):
    """The port's evaluate_humaniflow, as the CLI calls it, given the JAX
    key pool as its noise (JAX's: split(PRNGKey(0), 65), popped from the end)."""
    pool = jax.random.split(jax.random.PRNGKey(0), 65)

    def noise_fn(i, b, n):
        shape, levels = jax_noise(jm, pool[64 - i], b, n)
        return t(shape.astype(np.float32)), [t(z) for z in levels]

    inner = tevaluate.evaluate_humaniflow
    monkeypatch.setattr(tevaluate, "evaluate_humaniflow", lambda *a, **k: inner(*a, noise_fn=noise_fn, **k))


def _run_jax_cli(monkeypatch, argv):
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    try:
        module = importlib.import_module("run_evaluate")
    finally:
        sys.path.remove(os.path.join(REPO, "scripts"))
    monkeypatch.setattr(sys, "argv", ["run_evaluate.py", *argv])
    module.main()


def _per_frame(d):
    return {f: np.load(os.path.join(d, f)) for f in sorted(os.listdir(d)) if f.endswith("_per_frame.npy")}


@pytest.mark.parametrize("dataset", ["3dpw", "ssp3d"])
def test_evaluate_cli_matches_jax(files, dataset, monkeypatch, capsys):
    _point_paths(monkeypatch, files)
    _with_jax_noise(monkeypatch, files["jm"])
    out = {name: str(files["root"] / f"{dataset}_{name}") for name in ("jax", "port")}
    argv = ["-D", dataset, "-C", files["tar"], "-B", str(B), "-N", str(N), "--cfg", files["cfg"]]
    _run_jax_cli(monkeypatch, argv + ["-S", out["jax"]])
    final = run_evaluate.main(argv + ["-S", out["port"], "--device", "cpu"])
    want, got = _per_frame(out["jax"]), _per_frame(out["port"])
    assert sorted(got) == sorted(want) and len(want) >= 6
    np.testing.assert_array_equal(got.pop("fname_per_frame.npy"), want.pop("fname_per_frame.npy"))
    for f, w in want.items():
        assert got[f].shape == w.shape and w.shape[0] == N_FRAMES and np.isfinite(got[f]).all(), f
        if "IOU" in f:
            np.testing.assert_allclose(got[f], w, rtol=0, atol=IOU_ATOL, err_msg=f)
        else:
            assert rel_err(got[f], w) <= METRIC_RTOL, f
    assert all(np.isfinite(v) for v in final.values())
    assert str(final) in capsys.readouterr().out


def test_evaluate_cli_takes_a_checkpoint_of_train_humaniflow(files, monkeypatch):
    """-C with a train_humaniflow checkpoint (best_params; perturbed params)
    gives the per-frame metrics of the reference `.tar` of those weights,
    bit for bit."""
    from humaniflow_torch.utils.load_reference import load_humaniflow_checkpoint

    _point_paths(monkeypatch, files)
    best = load_humaniflow_checkpoint(files["tar"], TorchModel(files["tcfg"].MODEL, device="cpu")).state_dict()
    port = save_checkpoint(str(files["root"] / "experiment"), "epoch_000002", {
        "epoch": 2, "best_epoch": 1, "best_epoch_val_metrics": {"PVE-SC": 0.0712}, "best_params": best,
        "params": {k: v * 1.5 if v.is_floating_point() else v for k, v in best.items()},
        "opt_state": {"state": {}, "param_groups": []},
    })
    outs = {}
    for name, ckpt in (("tar", files["tar"]), ("port", port)):
        outs[name] = str(files["root"] / f"ckpt_{name}")
        torch.manual_seed(0)
        run_evaluate.main(["-D", "3dpw", "-C", ckpt, "-B", str(B), "-N", str(N), "--cfg", files["cfg"],
                           "-S", outs[name], "--device", "cpu"])
    want, got = _per_frame(outs["tar"]), _per_frame(outs["port"])
    assert sorted(got) == sorted(want)
    for f, w in want.items():
        np.testing.assert_array_equal(got[f], w, err_msg=f)
