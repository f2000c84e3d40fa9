"""The predict and evaluate CLIs on several ranks, on the CPU:
`run_predict --num_devices 2` (also with `--sample_devices 2`) and
`run_evaluate --num_devices 2` spawn 2 gloo ranks and write what the
one-device CLI writes.  The ranks find the fabricated files
(tests/_torch_parallel_cli_files.py) through HUMANIFLOW_MODEL_FILES and
HUMANIFLOW_DATA (configs/paths.py); the one-device runs, in this process,
through the same paths.  The train CLI's -D: tests/test_torch_parallel_cli_train.py."""

import os

import numpy as np
import pytest
from _torch_parallel_cli_files import ranks_env, write_cli_files

from humaniflow_torch.cli import run_evaluate, run_predict

cv2 = pytest.importorskip("cv2")

# Two ranks against one process: predictions 1e-5 (tests/test_parallel.py),
# metrics rtol 1e-4 (tests/test_evaluate.py:344; per-frame files relative to
# each file's largest value).
PRED_TOL = 1e-5
METRIC_RTOL = 1e-4


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    with ranks_env(write_cli_files(tmp_path_factory.mktemp("parallel_cli"))) as files:
        yield files


def _predict_argv(env):
    return ["-I", env["images"], "-C", env["ckpt"], "-N", "2", "--cfg", env["cfg"], "--hrnet_dtype", "f32",
            "--device", "cpu"]


@pytest.fixture(scope="module")
def one_device_predictions(env):
    out = str(env["root"] / "predict_one")
    run_predict.main(_predict_argv(env) + ["-S", out])
    return _npz_dir(out)


def _npz_dir(d):
    return {f: dict(np.load(os.path.join(d, f))) for f in sorted(os.listdir(d))}


@pytest.mark.parametrize("mesh_flags", [["--num_devices", "2"], ["--num_devices", "2", "--sample_devices", "2"]])
def test_predict_cli_on_two_ranks_writes_the_one_device_predictions(env, one_device_predictions, mesh_flags,
                                                                    tmp_path):
    run_predict.main(_predict_argv(env) + ["-S", str(tmp_path / "two"), *mesh_flags])
    want, got = one_device_predictions, _npz_dir(tmp_path / "two")
    assert sorted(got) == sorted(want) == ["a_pred.npz", "b_pred.npz"]
    for f, w in want.items():
        assert sorted(got[f]) == sorted(w)
        for k, v in w.items():
            np.testing.assert_allclose(got[f][k], v, rtol=PRED_TOL, atol=PRED_TOL, err_msg=f"{f} {k}")


def test_evaluate_cli_on_two_ranks_writes_the_one_device_metrics(env, tmp_path):
    """3DPW, 4 frames in batches of 3: both batches pad on 2 ranks."""
    argv = ["-D", "3dpw", "-C", env["ckpt"], "-B", "3", "-N", "2", "--cfg", env["cfg"], "--device", "cpu"]
    want_final = run_evaluate.main(argv + ["-S", str(tmp_path / "one")])
    got_final = run_evaluate.main(argv + ["-S", str(tmp_path / "two"), "--num_devices", "2"])
    assert set(got_final) == set(want_final)
    for m, v in want_final.items():
        np.testing.assert_allclose(got_final[m], v, rtol=METRIC_RTOL, err_msg=m)
    want, got = (sorted(os.listdir(tmp_path / d)) for d in ("one", "two"))
    assert got == want and len(want) >= 20
    for f in want:
        w, g = np.load(tmp_path / "one" / f), np.load(tmp_path / "two" / f)
        if w.dtype.kind in "US":
            np.testing.assert_array_equal(g, w, err_msg=f)
        else:  # relative to the file's largest value, as tests/test_torch_eval.py compares per-frame files
            assert g.shape == w.shape and np.abs(g - w).max() <= METRIC_RTOL * np.abs(w).max(), f
