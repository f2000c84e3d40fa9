"""`python -m humaniflow_torch.cli.run_train` on the CPU, on fabricated
training files and an SMPL file from the port's converter: two epochs, the
frozen config that the JAX CLI would write, the log and the checkpoints,
then a resume for a third epoch from the frozen config; `--trace_spans`."""

import math
import os
import pickle

import pytest
import torch
from test_torch_train_data import write_smpl_pickle, write_training_files

from humaniflow_torch.cli import run_train
from humaniflow_torch.configs import paths as tpaths
from humaniflow_torch.models.smpl import convert_smpl_pkl
from humaniflow_torch.utils.checkpoints import load_checkpoint
from humaniflow_tpu.configs import load_config as jax_load_config
from humaniflow_tpu.configs import save_config as jax_save_config

pytest.importorskip("cv2")

IMG = 32
OVERRIDES = ["TRAIN.BATCH_SIZE", "2", "TRAIN.NUM_EPOCHS", "2", "TRAIN.EPOCHS_PER_SAVE", "1",
             "DATA.PROXY_REP_SIZE", str(IMG), "TRAIN.SYNTH_DATA.FOCAL_LENGTH", str(300.0 * IMG / 256.0)]
CHECKPOINT_KEYS = {"epoch", "best_epoch", "best_epoch_val_metrics", "params", "best_params", "opt_state"}


def _point_paths(monkeypatch, root):
    files = write_training_files(str(root / "training"), n_train=2, n_val=2, n_backgrounds=3)
    for split, (poses, textures, backgrounds) in files.items():
        monkeypatch.setattr(tpaths, f"{split.upper()}_POSES_PATH", poses)
        monkeypatch.setattr(tpaths, f"{split.upper()}_TEXTURES_PATH", textures)
        monkeypatch.setattr(tpaths, f"{split.upper()}_BACKGROUNDS_PATH", backgrounds)
    write_smpl_pickle(root / "SMPL_NEUTRAL.pkl")
    convert_smpl_pkl(str(root / "SMPL_NEUTRAL.pkl"), str(root / "SMPL_NEUTRAL.npz"))
    monkeypatch.setattr(tpaths, "SMPL_NEUTRAL", str(root / "SMPL_NEUTRAL.npz"))


def _log(exp):
    with open(os.path.join(exp, "log.pkl"), "rb") as f:
        return pickle.load(f)


def test_train_cli_two_epochs_then_resume(tmp_path, monkeypatch, capsys):
    _point_paths(monkeypatch, tmp_path)
    exp = str(tmp_path / "experiment")
    torch.manual_seed(0)
    run_train.main(["-E", exp, "-P", "all", "-O", *OVERRIDES, "--device", "cpu"])
    assert "Found 2 train / 2 val poses." in capsys.readouterr().out

    # the frozen config: the text the JAX CLI writes for the same overrides
    jax_save_config(jax_load_config(None, OVERRIDES), str(tmp_path / "jax.yaml"))
    frozen = (tmp_path / "experiment" / "config.yaml").read_text()
    assert frozen == (tmp_path / "jax.yaml").read_text()

    first = _log(exp)
    assert len(first["train_losses"]) == 2 and len(first["val_losses"]) == 2
    assert all(math.isfinite(x) for k in ("train_losses", "val_losses", "val_PVE-SC") for x in first[k])
    ckpts = [load_checkpoint(os.path.join(exp, f"epoch_{e:06d}")) for e in (0, 1)]
    for e, ckpt in enumerate(ckpts):
        assert set(ckpt) == CHECKPOINT_KEYS and ckpt["epoch"] == e
        assert all(torch.isfinite(v).all() for v in ckpt["params"].values() if v.is_floating_point())
    assert any(not torch.equal(ckpts[0]["params"][k], ckpts[1]["params"][k]) for k in ckpts[0]["params"])
    assert not os.path.exists(os.path.join(exp, "epoch_000002.pt"))

    # resume from epoch 1 for a third epoch: the frozen config with this run's -O, the file left as it was
    run_train.main(["-E", exp, "-R", "1", "-O", "TRAIN.NUM_EPOCHS", "3", "--device", "cpu"])
    assert (tmp_path / "experiment" / "config.yaml").read_text() == frozen
    history = _log(exp)
    assert len(history["train_losses"]) == 3 and history["train_losses"][:2] == first["train_losses"]
    third = load_checkpoint(os.path.join(exp, "epoch_000002"))
    assert third["epoch"] == 2 and set(third) == CHECKPOINT_KEYS
    assert third["params"]["fc1.weight"].shape == ckpts[1]["params"]["fc1.weight"].shape
    assert not torch.equal(third["params"]["fc1.weight"], ckpts[1]["params"]["fc1.weight"])


def test_train_cli_writes_the_span_summary(tmp_path, monkeypatch):
    """`run_train --trace_spans PATH` for one epoch: PATH holds the synthetic
    batch's and the train step's spans, a step for each training batch."""
    import json

    _point_paths(monkeypatch, tmp_path)
    spans = tmp_path / "spans.json"
    overrides = list(OVERRIDES)
    overrides[overrides.index("TRAIN.NUM_EPOCHS") + 1] = "1"
    run_train.main(["-E", str(tmp_path / "experiment"), "-O", *overrides, "--device", "cpu",
                    "--trace_spans", str(spans)])
    summary = json.loads(spans.read_text())
    for name in ("synth", "synth.render", "train_step", "train_step.backward", "train_step.check"):
        assert summary[name]["calls"] >= 1 and summary[name]["host_s"] > 0, name
    assert summary["train_step.backward"]["calls"] == 1  # one training batch of 2; the validation step has none
    assert summary["train_step.forward"]["calls"] == summary["train_step"]["calls"] == 2
