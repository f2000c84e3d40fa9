"""A fabricated 3DPW release, laid out as the real one: sequenceFiles/test/*.pkl
(dicts pickled with protocol 2, read back with encoding="latin1") and
imageFiles/<sequence>/image_%05d.jpg; and the checks that hold two
preprocessings of it to each other.  Shared by the port's preprocessing
tests and chip_smoke.py's phase 17; imports neither JAX nor torch."""

import os
import pickle

import numpy as np


def _rodrigues(aa):
    """Axis-angle (..., 3) → rotation matrices (..., 3, 3), float64."""
    theta = np.linalg.norm(aa, axis=-1, keepdims=True)[..., None]
    k = aa / np.maximum(np.linalg.norm(aa, axis=-1, keepdims=True), 1e-12)
    kx = np.zeros(aa.shape[:-1] + (3, 3))
    kx[..., 0, 1], kx[..., 0, 2], kx[..., 1, 2] = -k[..., 2], k[..., 1], -k[..., 0]
    kx = kx - np.swapaxes(kx, -1, -2)
    return np.eye(3) + np.sin(theta) * kx + (1 - np.cos(theta)) * kx @ kx


def write_pw3d_release(root, sequences, frame_wh=(1080, 1920), focal=1960.0, distinct_frames=4, seed=0):
    """Write a 3DPW test release under root.

    :param sequences: one dict per sequence: name, frames (count), people
        (one (gender "m" or "f", invalid frame indices) pair a person) and
        missing (frame indices whose image is left out).
    :param frame_wh: the frames' (width, height); a few distinct JPEG frames
        are written once and copied to fill each sequence.
    :param focal: the intrinsics' focal length in pixels, the principal
        point at the frame's centre.
    The people stand upright 2-6 m in front of a slightly turning camera,
    in small-angle SMPL poses; some reach past the frame's border.
    """
    import cv2

    rng = np.random.default_rng(seed)
    w, h = frame_wh
    seq_dir = os.path.join(root, "sequenceFiles", "test")
    os.makedirs(seq_dir, exist_ok=True)
    jpegs = []
    for _ in range(distinct_frames):
        small = rng.integers(0, 256, (max(h // 16, 2), max(w // 16, 2), 3), dtype=np.uint8)
        ok, buf = cv2.imencode(".jpg", cv2.resize(small, (w, h), interpolation=cv2.INTER_LINEAR))
        assert ok
        jpegs.append(buf.tobytes())
    for seq in sequences:
        n = seq["frames"]
        img_dir = os.path.join(root, "imageFiles", seq["name"])
        os.makedirs(img_dir, exist_ok=True)
        for fi in range(n):
            if fi not in seq.get("missing", ()):
                with open(os.path.join(img_dir, f"image_{fi:05d}.jpg"), "wb") as f:
                    f.write(jpegs[fi % distinct_frames])
        cam_poses = np.tile(np.eye(4), (n, 1, 1))
        cam_poses[:, :3, :3] = _rodrigues(rng.normal(scale=0.05, size=3) + rng.normal(scale=0.01, size=(n, 3)))
        cam_poses[:, :3, 3] = rng.normal(scale=0.05, size=(n, 3))
        poses, betas, genders, poses2d, trans, valid = [], [], [], [], [], []
        for gender, invalid in seq["people"]:
            pose = rng.normal(scale=0.15, size=(n, 72))
            pose[:, :3] = np.array([np.pi, 0.0, 0.0]) + rng.normal(scale=0.2, size=(n, 3))  # upright, facing the camera
            z = np.linspace(*rng.uniform(2.0, 6.0, size=2), n)
            # the root projects within 0.9 of the half-width of the centre: some
            # boxes run past the frame's border, none lies wholly outside it
            # (the JAX script's crop does not take a box wholly outside)
            u = np.linspace(*rng.uniform(-0.9, 0.9, size=2), n)
            t = np.stack([u * z * w / (2 * focal), rng.uniform(-0.2, 0.2, n), z], -1)
            poses.append(pose)
            betas.append(rng.normal(scale=0.5, size=10))
            genders.append(gender)
            kp = np.stack([rng.uniform(0, w, (n, 18)), rng.uniform(0, h, (n, 18)), rng.uniform(0, 1, (n, 18))], 1)
            poses2d.append(kp)
            trans.append(t)
            ok = np.ones(n, bool)
            ok[list(invalid)] = False
            valid.append(ok)
        blob = {"sequence": seq["name"], "poses": poses, "betas": betas, "genders": genders, "poses2d": poses2d,
                "cam_poses": cam_poses, "campose_valid": valid, "trans": trans,
                "cam_intrinsics": np.array([[focal, 0.0, w / 2], [0.0, focal, h / 2], [0.0, 0.0, 1.0]])}
        with open(os.path.join(seq_dir, f"{seq['name']}.pkl"), "wb") as f:
            pickle.dump(blob, f, protocol=2)


def smpl_rows(sequences):
    """The frame count of each person with a valid frame whose image exists:
    the rows of each SMPL call the preprocessing makes, in its order."""
    rows = []
    for seq in sorted(sequences, key=lambda s: s["name"]):
        for _, invalid in seq["people"]:
            r = sum(1 for fi in range(seq["frames"]) if fi not in invalid and fi not in seq.get("missing", ()))
            if r:
                rows.append(r)
    return rows


def frames_of(imgnames):
    """(sequence, person, frame) of each preprocessed frame, from its file name."""
    out = []
    for name in imgnames:
        seq_name, rest = str(name).rsplit("_p", 1)
        p, fi = rest[: -len(".png")].split("_frame")
        out.append((seq_name, int(p), int(fi)))
    return out


def read_sequence(root, seq_name):
    with open(os.path.join(root, "sequenceFiles", "test", f"{seq_name}.pkl"), "rb") as f:
        return pickle.load(f, encoding="latin1")


def hold_labels(want, got):
    """Two preprocessings' 3dpw_test.npz contents (dicts of arrays): every
    key with the same dtype (strings: of any length) and shape; names,
    genders, shapes and body poses equal."""
    assert sorted(got) == sorted(want) == ["gender", "imgname", "joints2D_coco", "pose", "shape"]
    for k in want:
        same_type = got[k].dtype == want[k].dtype or got[k].dtype.kind == want[k].dtype.kind == "U"
        assert same_type and got[k].shape == want[k].shape, k
    for k in ("imgname", "gender", "shape"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(got["pose"][:, 3:], want["pose"][:, 3:])


def logged_rotations(root, names, so3_exp, so3_log, per_person=True):
    """What a preprocessing logs for each named frame, computed apart from it:
    the float32 rotations R_cam · so3_exp(pose[:3]) (the product in float64,
    as the scripts form it) and their so3_log, float32.  so3_exp and so3_log
    map numpy float32 arrays to numpy arrays; they are called once over each
    person's frames (per_person, the port's batching) or once a frame (the
    JAX script's).  Returns (rotations (F, 3, 3), orientations (F, 3))."""
    import itertools

    frames = frames_of(names)
    groups = [list(g) for _, g in itertools.groupby(frames, key=lambda f: f[:2])] if per_person else \
        [[f] for f in frames]
    rots, logs = [], []
    for group in groups:
        seq = read_sequence(root, group[0][0])
        idx = [fi for _, _, fi in group]
        r_glob = np.asarray(so3_exp(np.asarray(seq["poses"][group[0][1]])[idx, :3].astype(np.float32)))
        cam = np.asarray(seq["cam_poses"])[idx, :3, :3]
        r = np.stack([cam[i] @ r_glob[i] for i in range(len(idx))]).astype(np.float32)
        rots.append(r)
        logs.append(np.asarray(so3_log(r), np.float32))
    return np.concatenate(rots), np.concatenate(logs)


def hold_orientations(want_pose, got_pose, want_logged, got_logged, atol, log_atol):
    """The camera-turned global orientations (pose[:, :3]) of two
    preprocessings.  Each side's is, bit for bit, the so3_log of the rotation
    it logs (want_logged, got_logged: logged_rotations' pairs); the two sides'
    rotations lie within atol of each other; each orientation's rotation lies
    within log_atol of the rotation it logs (float32 so3_log's own loss,
    largest near θ = π); so the two orientations as rotation matrices (the π
    branch may pick either sign of the axis-angle) lie within
    atol + 2·log_atol.  Returns (the orientations' largest difference, the
    rotations', so3_log's largest loss)."""
    loss = 0.0
    for pose, (r, log) in ((want_pose, want_logged), (got_pose, got_logged)):
        np.testing.assert_array_equal(pose[:, :3], log.astype(np.float64))
        loss = max(loss, float(np.abs(_rodrigues(pose[:, :3]) - r).max()))
    r_apart = float(np.abs(got_logged[0] - want_logged[0]).max())
    diff = float(np.abs(_rodrigues(got_pose[:, :3]) - _rodrigues(want_pose[:, :3])).max())
    assert r_apart <= atol and loss <= log_atol and diff <= atol + 2 * log_atol, (r_apart, loss, diff)
    return diff, r_apart, loss


def hold_crops(want_dir, got_dir, names, want_corners, got_corners, want_j2d, got_j2d, corner_atol, j2d_atol,
               clear_share):
    """Box corners (F, 4) before rounding within corner_atol; on every frame
    whose corners lie further from a rounding boundary than that frame's
    corners lie apart on the two sides (so that no rounding can differ), the
    integer boxes and the PNG crops agree, and so do the 2D joints within
    j2d_atol px once one side's are scaled by the two boxes' sizes (a joint
    far from the box's corner moves with the box's size: at 0.02 px apart on
    a 400 px box, a joint 300 px off moves by 0.015 px); those frames are at
    least clear_share of the set.  Returns (the largest distance apart,
    share of such frames)."""
    import cv2

    apart = np.abs(got_corners - want_corners).max(axis=1)
    assert apart.max() <= corner_atol, apart.max()
    to_boundary = np.abs((got_corners - 0.5) - np.round(got_corners - 0.5)).min(axis=1)
    clear = to_boundary > apart
    assert clear.mean() >= clear_share, (clear.mean(), apart.max())
    rounded = np.vectorize(lambda x: int(round(x)))  # Python's rounding, as the scripts'
    np.testing.assert_array_equal(rounded(got_corners)[clear], rounded(want_corners)[clear])
    for i in np.nonzero(clear)[0]:
        a = cv2.imread(os.path.join(got_dir, "cropped_frames", str(names[i])))
        b = cv2.imread(os.path.join(want_dir, "cropped_frames", str(names[i])))
        np.testing.assert_array_equal(a, b, err_msg=str(names[i]))
    size_ratio = (want_corners[:, 1] - want_corners[:, 0]) / (got_corners[:, 1] - got_corners[:, 0])
    want_scaled = want_j2d.astype(np.float64)
    want_scaled[..., :2] *= size_ratio[:, None, None]
    np.testing.assert_allclose(got_j2d[clear], want_scaled[clear], atol=j2d_atol, rtol=0)
    return float(apart.max()), float(clear.mean())
