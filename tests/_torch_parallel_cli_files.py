"""Fabricated inputs of the multi-rank CLI tests (tests/test_torch_parallel_cli*.py):
model files and data in the layout of humaniflow_torch/configs/paths.py, and
the environment through which spawned ranks find them."""

import contextlib
import dataclasses
import os
import runpy
import shutil

import numpy as np
import pytest
import torch
from test_evaluate import _build_pw3d_dir
from test_torch_train_data import write_smpl_pickle, write_training_files

from humaniflow_torch.configs import get_humaniflow_cfg_defaults
from humaniflow_torch.configs import paths as tpaths
from humaniflow_torch.models import HumaniflowModel
from humaniflow_torch.models.smpl import convert_smpl_pkl
from humaniflow_torch.utils.checkpoints import save_checkpoint

IMG = 32


def write_cli_files(root):
    """Model files (SMPL from the port's converter, the repository's
    regressors) and data (3DPW, training files) in the layout of
    configs/paths.py, two images, a 32² config and a checkpoint of the
    port's training loop, under root."""
    import cv2

    model_files, data = root / "model_files", root / "data"
    (model_files / "smpl").mkdir(parents=True)
    for name in ("J_REGRESSOR_EXTRA", "COCOPLUS_REGRESSOR", "H36M_REGRESSOR", "DENSEPOSE_UV"):
        shutil.copy(getattr(tpaths, name), model_files)  # the repository's own
    for seed, gender in enumerate(("NEUTRAL", "MALE", "FEMALE")):
        write_smpl_pickle(root / f"SMPL_{gender}.pkl", seed=seed)
        convert_smpl_pkl(str(root / f"SMPL_{gender}.pkl"), str(model_files / "smpl" / f"SMPL_{gender}.npz"))
    written = write_training_files(str(root / "written"), n_train=2, n_val=2, n_backgrounds=3)
    training = data / "training"
    (training / "lsun_backgrounds").mkdir(parents=True)
    for split, (poses, textures, backgrounds) in written.items():
        shutil.move(poses, training / f"smpl_{split}_poses.npz")
        shutil.move(textures, training / f"smpl_{split}_textures.npz")
        shutil.move(backgrounds, training / "lsun_backgrounds" / split)
    (data / "3dpw" / "test").mkdir(parents=True)
    _build_pw3d_dir(str(data / "3dpw" / "test"), n=4)
    images = root / "images"
    images.mkdir()
    rng = np.random.default_rng(6)
    for name, (h, w) in (("a.png", (48, 40)), ("b.png", (36, 52))):
        cv2.imwrite(str(images / name), rng.integers(0, 255, size=(h, w, 3)).astype(np.uint8))
    cfg = root / "small.yaml"
    cfg.write_text(f"DATA:\n  PROXY_REP_SIZE: {IMG}\n")
    model_cfg = get_humaniflow_cfg_defaults()
    model_cfg.DATA = dataclasses.replace(model_cfg.DATA, PROXY_REP_SIZE=IMG)
    best = HumaniflowModel(model_cfg.MODEL, device="cpu", generator=torch.Generator().manual_seed(4)).state_dict()
    ckpt = save_checkpoint(str(root / "experiment"), "epoch_000001", {
        "epoch": 1, "best_epoch": 1, "best_epoch_val_metrics": {}, "best_params": best, "params": best,
        "opt_state": {"state": {}, "param_groups": []},
    })
    return dict(root=root, model_files=str(model_files), data=str(data), images=str(images), cfg=str(cfg),
                ckpt=ckpt)


@contextlib.contextmanager
def ranks_env(files):
    """The ranks' environment (one OpenMP thread a rank) and, for the
    one-device runs in the test's process, the paths module as the ranks
    will build it."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HUMANIFLOW_MODEL_FILES", files["model_files"])
        mp.setenv("HUMANIFLOW_DATA", files["data"])
        mp.setenv("OMP_NUM_THREADS", "1")
        for name, value in runpy.run_path(tpaths.__file__).items():
            if name.isupper():
                mp.setattr(tpaths, name, value)
        yield files
