"""The training data against humaniflow_tpu on the CPU, on fabricated
files: the SMPL converter's .npz, the JPEG loader's decodes and the
synthetic-training sampler's batches, all bit for bit."""

import os
import pickle

import numpy as np
import pytest
import scipy.sparse
import torch

from humaniflow_torch.cli import convert_model_files
from humaniflow_torch.data import native_loader as tloader
from humaniflow_torch.data.datasets import OnTheFlySMPLTrainDataset as TorchDataset
from humaniflow_torch.models import smpl as tsmpl
from humaniflow_tpu.data import native_loader as jloader
from humaniflow_tpu.data.datasets import OnTheFlySMPLTrainDataset as JaxDataset
from humaniflow_tpu.models import smpl as jsmpl

cv2 = pytest.importorskip("cv2")

POSE_PREFIXES = ("h36m", "up3d", "3dpw", "amass_cmu", "h36m", "surreal", "3dpw", "up3d", "amass_kit", "h36m")


def write_smpl_pickle(path, num_verts=6890, seed=0):
    """An SMPL .pkl as the released files lay it out (posedirs (V, 3, 207),
    a scipy-sparse J_regressor, faces as uint32) from synthetic_smpl's
    arrays."""
    s = tsmpl.synthetic_smpl(num_verts=num_verts, seed=seed, device="cpu")
    v = s.v_template.shape[0]
    with open(path, "wb") as f:
        pickle.dump({
            "v_template": s.v_template.numpy().astype(np.float64),
            "shapedirs": s.shapedirs.numpy().astype(np.float64),
            "posedirs": s.posedirs.numpy().T.reshape(v, 3, -1).astype(np.float64),
            "J_regressor": scipy.sparse.csc_matrix(s.j_regressor.numpy().astype(np.float64)),
            "weights": s.lbs_weights.numpy().astype(np.float64),
            "f": s.faces.numpy().astype(np.uint32),
            "kintree_table": np.zeros((2, 24), np.int64),
        }, f, protocol=2)
    return s


def write_training_files(root, n_train=10, n_val=4, n_backgrounds=5, seed=0):
    """Poses .npz (fnames with the datasets' prefixes), textures .npz (grey
    and non-grey stacks of (1200, 800, 3) uint8) and JPEG backgrounds, for
    the train and val splits; returns {split: (poses, textures, backgrounds)}."""
    rng = np.random.default_rng(seed)
    out = {}
    for split, n in (("train", n_train), ("val", n_val)):
        d = os.path.join(root, split)
        os.makedirs(os.path.join(d, "backgrounds"))
        poses = os.path.join(d, "poses.npz")
        fnames = [f"{POSE_PREFIXES[i % len(POSE_PREFIXES)]}_{i:04d}" for i in range(n)]
        np.savez(poses, fnames=np.array(fnames), poses=rng.normal(scale=0.3, size=(n, 72)).astype(np.float32))
        textures = os.path.join(d, "textures.npz")
        np.savez(textures, grey=rng.integers(0, 256, (2, 1200, 800, 3), dtype=np.uint8),
                 nongrey=rng.integers(0, 256, (3, 1200, 800, 3), dtype=np.uint8))
        for i in range(n_backgrounds):
            h, w = (48 + 8 * i, 64 - 4 * i)
            yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w), indexing="ij")
            img = (np.stack([xx, yy, 0.5 * (xx + yy) * (i + 1) / n_backgrounds], -1) * 255).astype(np.uint8)
            cv2.imwrite(os.path.join(d, "backgrounds", f"bg_{i}.jpg"), cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
        with open(os.path.join(d, "backgrounds", "notes.txt"), "w") as f:
            f.write("not an image")
        out[split] = (poses, textures, os.path.join(d, "backgrounds"))
    return out


# ------------------------------------------------------------ SMPL files


def test_convert_smpl_pkl_matches_jax(tmp_path):
    """Every array of the port's .npz equals the JAX converter's, bit for
    bit, and loads as the same model; the CLI writes the same file."""
    s = write_smpl_pickle(tmp_path / "SMPL_NEUTRAL.pkl")
    jsmpl.convert_smpl_pkl(str(tmp_path / "SMPL_NEUTRAL.pkl"), str(tmp_path / "jax.npz"))
    tsmpl.convert_smpl_pkl(str(tmp_path / "SMPL_NEUTRAL.pkl"), str(tmp_path / "port.npz"))
    out = convert_model_files.main(["--smpl_pkl", str(tmp_path / "SMPL_NEUTRAL.pkl"), "--out_dir",
                                    str(tmp_path / "converted")])["smpl"]
    assert out == str(tmp_path / "converted" / "SMPL_NEUTRAL.npz")
    want = dict(np.load(tmp_path / "jax.npz"))
    assert sorted(want) == ["J_regressor", "f", "posedirs", "shapedirs", "v_template", "weights"]
    for path in (tmp_path / "port.npz", out):
        got = dict(np.load(path))
        assert sorted(got) == sorted(want)
        for k, w in want.items():
            assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
            np.testing.assert_array_equal(got[k], w, err_msg=k)
    assert want["posedirs"].shape == (207, 6890 * 3) and want["f"].dtype == np.int64

    regs = {"h36m": os.path.join(os.path.dirname(os.path.dirname(__file__)), "model_files", "J_regressor_h36m.npy")}
    a = tsmpl.load_smpl_npz(str(tmp_path / "port.npz"), regressor_paths=regs, device="cpu")
    b = tsmpl.load_smpl_npz(str(tmp_path / "jax.npz"), regressor_paths=regs, device="cpu")
    for name in ("v_template", "shapedirs", "posedirs", "j_regressor", "lbs_weights", "faces", "j_regressor_h36m"):
        torch.testing.assert_close(getattr(a, name), getattr(b, name), rtol=0, atol=0)
    # the synthetic model round-trips through the released layout
    torch.testing.assert_close(a.posedirs, s.posedirs, rtol=0, atol=0)
    torch.testing.assert_close(a.j_regressor, s.j_regressor, rtol=0, atol=0)


# ----------------------------------------------------------- JPEG loader


@pytest.fixture(scope="module")
def training_files(tmp_path_factory):
    return write_training_files(str(tmp_path_factory.mktemp("training")))


def test_jpeg_loader_matches_jax(training_files):
    """The same decode as the JAX package's on the same files: its native
    library (or both packages' OpenCV fallback), bit for bit; a file that
    does not decode gives zeros."""
    backgrounds = training_files["train"][2]
    paths = sorted(os.path.join(backgrounds, f) for f in os.listdir(backgrounds) if f.endswith(".jpg"))
    paths = paths + ["/nonexistent/x.jpg", paths[0]]
    assert tloader.native_available() == (tloader.build_error() is None)
    assert tloader.native_available() == jloader.native_available()
    for wh in (32, 57):
        got = tloader.decode_jpeg_batch(paths, wh, num_threads=3)
        want = jloader.decode_jpeg_batch(paths, wh, num_threads=3)
        assert got.shape == (len(paths), wh, wh, 3) and got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
        assert got[-2].max() == 0.0 and got[0].max() > 0.0
        np.testing.assert_array_equal(got[-1], got[0])
    out = np.full((2, 16, 16, 3), 7.0, np.float32)
    assert tloader.decode_jpeg_batch(paths[:2], 16, out=out) is out and out.max() < 2.0
    with pytest.raises(ValueError):
        tloader.decode_jpeg_batch(paths[:2], 16, out=np.empty((2, 16, 16, 3), np.float64))


def test_jpeg_loader_opencv_fallback_matches_jax(training_files, monkeypatch):
    """Without the native library (no libjpeg headers, say) both packages
    decode with OpenCV, to the same bits."""
    backgrounds = training_files["val"][2]
    paths = sorted(os.path.join(backgrounds, f) for f in os.listdir(backgrounds)) + ["/nonexistent/x.jpg"]
    monkeypatch.setattr(tloader, "_load_library", lambda: None)
    monkeypatch.setattr(jloader, "_load_library", lambda: None)
    assert not tloader.native_available()
    got, want = tloader.decode_jpeg_batch(paths, 40), jloader.decode_jpeg_batch(paths, 40)
    np.testing.assert_array_equal(got, want)
    assert got[-1].max() == 0.0 and got[-2].max() == 0.0 and got[0].max() > 0.0  # notes.txt, the missing file


def test_prefetching_loader_keeps_the_order():
    made = []

    def make(i):
        made.append(i)
        return {"i": i}

    assert [b["i"] for b in tloader.PrefetchingLoader(make, 5)] == [0, 1, 2, 3, 4]
    assert made == [0, 1, 2, 3, 4]
    assert list(tloader.PrefetchingLoader(make, 0)) == []


# ------------------------------------------------------ training sampler


@pytest.mark.parametrize("grey_tex_prob", [0.05, 0.5])
def test_training_dataset_matches_jax_over_two_epochs(training_files, grey_tex_prob):
    """The same seed gives the same batches, bit for bit: poses, textures
    (both stacks drawn at 0.5) and decoded backgrounds."""
    poses, textures, backgrounds = training_files["train"]
    kw = dict(img_wh=32, seed=3, grey_tex_prob=grey_tex_prob)
    jd, td = JaxDataset(poses, textures, backgrounds, **kw), TorchDataset(poses, textures, backgrounds, **kw)
    assert len(td) == len(jd) == 10 and td.backgrounds_paths == jd.backgrounds_paths
    for _ in range(2):
        want, got = list(jd.epoch_batches(3)), list(td.epoch_batches(3))
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            assert sorted(g) == ["background", "pose", "texture"]
            for k in w:
                assert g[k].dtype == w[k].dtype == np.float32, k
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    tail = list(td.epoch_batches(4, shuffle=False, drop_last=False))
    assert [len(b["pose"]) for b in tail] == [4, 4, 2]
    np.testing.assert_array_equal(tail[0]["pose"], td.poses[:4])


@pytest.mark.parametrize("params_from", ["all", "h36m", "up3d", "3dpw", "amass", "not_amass"])
def test_training_dataset_selects_the_poses_jax_selects(training_files, params_from):
    poses, textures, backgrounds = training_files["train"]
    jd = JaxDataset(poses, textures, backgrounds, params_from=params_from)
    td = TorchDataset(poses, textures, backgrounds, params_from=params_from)
    assert td.fnames == jd.fnames and len(td) > 0
    np.testing.assert_array_equal(td.poses, jd.poses)
    if params_from == "amass":
        assert all(not str(f).startswith(("h36m", "up3d", "3dpw")) for f in td.fnames)
