"""`run_train -D 2` on the CPU: 2 gloo ranks write what the one-device
train CLI writes.  The ranks find the fabricated training files
(tests/_torch_parallel_cli_files.py) through HUMANIFLOW_MODEL_FILES and
HUMANIFLOW_DATA (configs/paths.py); the one-device run, in this process,
through the same paths."""

import os
import pickle

import numpy as np
import pytest
import torch
from _torch_parallel_cli_files import IMG, ranks_env, write_cli_files

from humaniflow_torch.cli import run_train
from humaniflow_torch.utils.checkpoints import load_checkpoint

pytest.importorskip("cv2")

# Two ranks against one process: losses rtol 1e-3, parameters atol 2e-3 /
# rtol 1e-3 (tests/test_train_pipeline.py:160-170).
LOSS_RTOL = 1e-3
PARAM_ATOL, PARAM_RTOL = 2e-3, 1e-3
TRAIN_OVERRIDES = ["TRAIN.BATCH_SIZE", "2", "TRAIN.NUM_EPOCHS", "1", "TRAIN.EPOCHS_PER_SAVE", "1",
                   "DATA.PROXY_REP_SIZE", str(IMG), "TRAIN.SYNTH_DATA.FOCAL_LENGTH", str(300.0 * IMG / 256.0)]


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    with ranks_env(write_cli_files(tmp_path_factory.mktemp("parallel_cli_train"))) as files:
        yield files


def test_train_cli_on_two_ranks_writes_the_one_device_run(env, tmp_path):
    """An epoch at TRAIN.BATCH_SIZE 2, one pose a rank: the frozen config,
    rank 0's checkpoint and log, the train batch's loss and the state after
    its step.  What follows an Adam step is not compared: from these random
    weights it is chaotic (the one-device CLI's own second-epoch loss moves
    by 5% between 1 and 8 CPU threads); tests/test_torch_parallel_train.py
    compares the whole loop where it is not."""
    runs = {}
    for name, flags in (("one", []), ("two", ["-D", "2"])):
        exp = str(tmp_path / name)
        torch.manual_seed(0)
        run_train.main(["-E", exp, "-O", *TRAIN_OVERRIDES, "--device", "cpu", *flags])
        with open(os.path.join(exp, "log.pkl"), "rb") as f:
            runs[name] = (sorted(os.listdir(exp)), pickle.load(f), load_checkpoint(os.path.join(exp, "epoch_000000")))
    (want_files, want_log, want_ckpt), (got_files, got_log, got_ckpt) = runs["one"], runs["two"]
    assert got_files == want_files == ["config.yaml", "epoch_000000.pt", "log.pkl"]
    assert (tmp_path / "two" / "config.yaml").read_text() == (tmp_path / "one" / "config.yaml").read_text()
    assert len(got_log["train_losses"]) == 1 and all(np.isfinite(got_log[k]).all() for k in want_log)
    np.testing.assert_allclose(got_log["train_losses"], want_log["train_losses"], rtol=LOSS_RTOL)
    assert got_ckpt["epoch"] == want_ckpt["epoch"] == 0
    for k, v in want_ckpt["params"].items():
        np.testing.assert_allclose(got_ckpt["params"][k].numpy(), v.numpy(), atol=PARAM_ATOL, rtol=PARAM_RTOL,
                                   err_msg=k)
