"""The port's 3DPW preprocessing (humaniflow_torch/cli/pw3d_preprocess.py)
against scripts/pw3d_preprocess.py on the CPU, on a fabricated release
(tests/_torch_pw3d.py): two sequences, one with three people (one of them
never valid), invalid frames and a missing image, with gendered SMPL files
from the port's converter."""

import importlib
import os
import sys

import numpy as np
import pytest
import torch
from _torch_pw3d import (
    _rodrigues,
    frames_of,
    hold_crops,
    hold_labels,
    hold_orientations,
    logged_rotations,
    read_sequence,
    smpl_rows,
    write_pw3d_release,
)
from test_torch_train_data import write_smpl_pickle

import humaniflow_tpu.models as jmodels
from humaniflow_torch.cli import pw3d_preprocess
from humaniflow_torch.configs import paths as tpaths
from humaniflow_torch.models import load_smpl_npz
from humaniflow_torch.models.smpl import convert_smpl_pkl
from humaniflow_torch.ops import so3_exp, so3_log
from humaniflow_tpu.configs import paths as jpaths
from humaniflow_tpu.ops import so3_exp as j_so3_exp
from humaniflow_tpu.ops import so3_log as j_so3_log

cv2 = pytest.importorskip("cv2")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Global orientations: each package's written orientation is, bit for bit,
# the so3_log of the rotation it logs (computed here apart from either
# script); the two packages' rotations within 1e-5; each orientation's
# rotation within 2e-3 of the rotation logged, about twice float32 so3_log's
# largest loss near θ = π over 200,000 draws (9.682e-4,
# test_so3_log_loss_near_pi); so as rotation matrices (so3_log's π branch may
# pick the other sign of the axis-angle) within 1e-5 + 2·2e-3.  An upright
# person facing the camera has θ ≈ π.  2D joints: 1e-2 px.  Box corners
# before rounding: 0.05 px apart at most; crops and integer boxes equal on
# every frame whose corners lie further from a rounding boundary than its
# two packages' corners lie apart, and those frames at least 90% of the set.
ROT_ATOL = 1e-5
LOG_ATOL = 2e-3
J2D_ATOL = 1e-2
CORNER_ATOL = 5e-2
CLEAR_SHARE = 0.9
FRAME_WH, FOCAL, CROP_WH = (64, 96), 116.0, 48
SEQUENCES = [
    {"name": "courtyard_walk_00", "frames": 7, "people": [("m", (2,)), ("f", (0, 6)), ("m", tuple(range(7)))],
     "missing": (4,)},
    {"name": "office_phone_00", "frames": 6, "people": [("f", (1,))]},
]


def _corners(verts, frames, pw3d_dir):
    """Box corners (x1, x2, y1, y2) before rounding of recorded SMPL vertices,
    through the port's host arithmetic (the JAX script's)."""
    out = []
    for v, (seq_name, p, fi) in zip(verts, frames):
        seq = read_sequence(pw3d_dir, seq_name)
        cx, cy, half = pw3d_preprocess.person_box(v + np.asarray(seq["trans"][p][fi]), np.asarray(seq["cam_poses"])[fi],
                                                  np.asarray(seq["cam_intrinsics"]), 1.2)
        out.append((cx - half, cx + half, cy - half, cy + half))
    return np.asarray(out)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The release, SMPL files, and both packages' outputs: (root, JAX's
    recorded SMPL vertices, the port's return value)."""
    root = tmp_path_factory.mktemp("pw3d")
    write_pw3d_release(str(root / "release"), SEQUENCES, frame_wh=FRAME_WH, focal=FOCAL, seed=3)
    smpl = {}
    for gender, seed in (("MALE", 1), ("FEMALE", 2)):
        write_smpl_pickle(root / f"SMPL_{gender}.pkl", seed=seed)
        smpl[gender] = str(root / f"SMPL_{gender}.npz")
        convert_smpl_pkl(str(root / f"SMPL_{gender}.pkl"), smpl[gender])
    jax_verts = []
    inner = jmodels.smpl_forward

    def recording(*args, **kwargs):
        out = inner(*args, **kwargs)
        jax_verts.append(np.asarray(out["vertices"][0]))
        return out

    argv = ["--pw3d_dir", str(root / "release"), "--crop_wh", str(CROP_WH)]
    with pytest.MonkeyPatch.context() as mp:
        for p in (jpaths, tpaths):
            for gender, path in smpl.items():
                mp.setattr(p, f"SMPL_{gender}", path)
        mp.setattr(jmodels, "smpl_forward", recording)
        sys.path.insert(0, os.path.join(REPO, "scripts"))
        try:
            script = importlib.import_module("pw3d_preprocess")
        finally:
            sys.path.remove(os.path.join(REPO, "scripts"))
        mp.setattr(sys, "argv", ["pw3d_preprocess.py", *argv, "--out_dir", str(root / "jax")])
        script.main()
        got = pw3d_preprocess.main([*argv, "--out_dir", str(root / "port"), "--device", "cpu"])
    return root, np.stack(jax_verts), got


def _npz(root, which):
    return dict(np.load(root / which / "3dpw_test.npz"))


def test_labels_match_jax(runs):
    """Every key with the JAX script's dtype and shape; the names, genders,
    shapes and body poses equal; one SMPL call per person with a frame, at
    its row count."""
    root, _, got = runs
    want, port = _npz(root, "jax"), _npz(root, "port")
    hold_labels(want, port)
    assert got["frames"] == len(want["imgname"]) == sum(smpl_rows(SEQUENCES)) == 14
    assert got["smpl_rows"] == smpl_rows(SEQUENCES) == [5, 4, 5]
    assert sorted(os.listdir(root / "port" / "cropped_frames")) == sorted(want["imgname"])


def _numpy(fn):
    """A torch function of the port on numpy float32 arrays, on the CPU."""
    return lambda a: fn(torch.from_numpy(a)).numpy()


def test_global_orientations_match_jax(runs):
    """Each script's written orientations are the so3_log of the rotations it
    logs, computed here (the JAX script's one frame at a time, the port's one
    person at a time); the port's so3_log of the JAX script's rotations gives
    the JAX script's bits; the two within ROT_ATOL and LOG_ATOL."""
    root = runs[0]
    want, port = _npz(root, "jax"), _npz(root, "port")
    release = str(root / "release")
    jax_logged = logged_rotations(release, want["imgname"], j_so3_exp, j_so3_log, per_person=False)
    port_logged = logged_rotations(release, port["imgname"], _numpy(so3_exp), _numpy(so3_log))
    np.testing.assert_array_equal(so3_log(torch.from_numpy(jax_logged[0])).numpy(), jax_logged[1])
    hold_orientations(want["pose"], port["pose"], jax_logged, port_logged, ROT_ATOL, LOG_ATOL)
    assert np.abs(np.linalg.norm(want["pose"][:, :3], axis=1) - np.pi).min() < 0.1  # the π branch is reached


@pytest.mark.parametrize("fault", ["untransformed", "reversed"])
def test_orientation_check_catches_a_wrong_turn(runs, fault):
    """The check above fails on the orientation left untransformed or turned
    the wrong way round (R_glob · R_cam)."""
    root = runs[0]
    want, port = _npz(root, "jax"), _npz(root, "port")
    release = str(root / "release")
    bad = dict(port, pose=port["pose"].copy())
    for i, (seq_name, p, fi) in enumerate(frames_of(port["imgname"])):
        seq = read_sequence(release, seq_name)
        aa = np.asarray(seq["poses"][p])[fi : fi + 1, :3].astype(np.float32)
        if fault == "reversed":
            r = so3_exp(torch.from_numpy(aa))[0].numpy() @ np.asarray(seq["cam_poses"])[fi, :3, :3]
            aa = so3_log(torch.from_numpy(r.astype(np.float32))[None]).numpy()
        bad["pose"][i, :3] = aa[0]
    jax_logged = logged_rotations(release, want["imgname"], j_so3_exp, j_so3_log, per_person=False)
    port_logged = logged_rotations(release, port["imgname"], _numpy(so3_exp), _numpy(so3_log))
    with pytest.raises(AssertionError):
        hold_orientations(want["pose"], bad["pose"], jax_logged, port_logged, ROT_ATOL, LOG_ATOL)
    # and without the bit-for-bit step: the rotation matrices lie further apart than the bound
    gap = np.abs(_rodrigues(bad["pose"][:, :3]) - _rodrigues(want["pose"][:, :3])).max()
    assert gap > ROT_ATOL + 2 * LOG_ATOL, gap


def test_so3_log_loss_near_pi():
    """The reading behind LOG_ATOL: float32 so3_log of rotations like the
    release's (θ near π, turned by a small camera rotation) loses at most
    half of LOG_ATOL of the rotation, over 200,000 seeded draws."""
    rng = np.random.default_rng(0)
    n = 200_000
    aa = (np.array([np.pi, 0.0, 0.0]) + rng.normal(scale=0.2, size=(n, 3))).astype(np.float32)
    cam = _rodrigues(rng.normal(scale=0.05, size=(n, 3)))
    r = (cam @ so3_exp(torch.from_numpy(aa)).numpy()).astype(np.float32)
    log = so3_log(torch.from_numpy(r)).numpy().astype(np.float64)
    loss = np.abs(_rodrigues(log) - r).max()
    print(f"float32 so3_log's largest loss near pi over {n} draws: {loss:.4g}")
    assert loss <= LOG_ATOL / 2, loss


def test_boxes_crops_and_joints_match_jax(runs):
    root, jax_verts, got = runs
    want, port = _npz(root, "jax"), _npz(root, "port")
    jax_corners = _corners(jax_verts, frames_of(want["imgname"]), str(root / "release"))
    hold_crops(str(root / "jax"), str(root / "port"), want["imgname"], jax_corners, got["corners"],
               want["joints2D_coco"], port["joints2D_coco"], CORNER_ATOL, J2D_ATOL, CLEAR_SHARE)
    # some boxes run past the frame's border
    w, h = FRAME_WH
    c = got["corners"]
    assert ((c[:, 0] < 0) | (c[:, 1] > w) | (c[:, 2] < 0) | (c[:, 3] > h)).any()


def test_batched_smpl_equals_per_frame_calls(runs):
    """The CLI's batching against one-frame calls, person by person: each
    person's valid frames with an image (the gather), their betas expanded
    to the frame count, and the split back into frames.  The CLI's written
    orientations equal a loop of pose_person at one frame each, bit for bit;
    its box corners those of the loop's vertices within 1e-4 px (two float32
    roundings of a coordinate move a corner by ~1e-5 px here); and
    pose_person over the gathered frames gives the loop's vertices within two
    float32 roundings of the largest coordinate (MKL sums the blend-shape and
    joint GEMMs in another order at one row; 1 ulp measured).  chip_smoke.py
    holds K2 itself to its one-row launches bit for bit on the card."""
    root, _, got = runs
    port = _npz(root, "port")
    release = str(root / "release")
    smpl = {g: load_smpl_npz(str(root / f"SMPL_{name}.npz"), device="cpu")
            for g, name in (("m", "MALE"), ("f", "FEMALE"))}
    frames = frames_of(port["imgname"])
    people = sorted({f[:2] for f in frames})
    assert len(people) == len(smpl_rows(SEQUENCES))
    for seq_name, p in people:
        seq = read_sequence(release, seq_name)
        idx = [i for i, f in enumerate(frames) if f[:2] == (seq_name, p)]
        fis = [frames[i][2] for i in idx]
        args = (smpl[seq["genders"][p][0]], np.asarray(seq["betas"][p][:10]))
        poses, cams = np.asarray(seq["poses"][p]), np.asarray(seq["cam_poses"])[:, :3, :3]
        one = [pw3d_preprocess.pose_person(*args, poses[fi : fi + 1], cams[fi : fi + 1], "cpu") for fi in fis]
        one_pose, one_verts = np.concatenate([o[0] for o in one]), np.concatenate([o[1] for o in one])
        np.testing.assert_array_equal(port["pose"][idx], one_pose)
        corners = _corners(one_verts, [frames[i] for i in idx], release)
        np.testing.assert_allclose(got["corners"][idx], corners, rtol=0, atol=1e-4)
        batched_pose, batched_verts = pw3d_preprocess.pose_person(*args, poses[fis], cams[fis], "cpu")
        np.testing.assert_array_equal(batched_pose, one_pose)
        ulps = 2 * np.finfo(np.float32).eps * float(np.abs(batched_verts).max())
        np.testing.assert_allclose(batched_verts, one_verts, rtol=0, atol=ulps)
