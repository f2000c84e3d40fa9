"""The port's flow-prior optimisation against humaniflow_tpu on the CPU: the
optimise loop on the same weights and init (both global-rotation inputs),
the halted freeze and the final-losses convention, the loss gradient at the
init (through the teacher-forced contexts), so3_exp's gradient at θ≈0 and
θ≈π, the optimise-data loader, the optimise CLI against JAX's, and kernel
K7's plain twin and gradient.  K7 on the card: tests/test_torch_kernels.py."""

import dataclasses
import functools
import importlib
import math
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import _reference_humaniflow_state_dict, jax_params_from_port, rel_err, small_cfgs, t
from scipy.spatial.transform import Rotation

import humaniflow_tpu.models.pallas_lbs as jlbs
from humaniflow_torch.configs import get_optimise_cfg_defaults as torch_opt_defaults
from humaniflow_torch.data.datasets import load_opt_initialise_data_from_pred_output as t_load_opt
from humaniflow_torch.models import HumaniflowModel as TorchModel
from humaniflow_torch.models import cuda_lbs
from humaniflow_torch.models import smpl as tsmpl
from humaniflow_torch.ops import so3_exp as t_so3_exp
from humaniflow_torch.pipelines import optimise_batch_with_humaniflow_prior as t_optimise
from humaniflow_torch.pipelines.predict import save_pred_output
from humaniflow_torch.utils.convert_jax import params_from_jax
from humaniflow_tpu.configs import get_optimise_cfg_defaults as jax_opt_defaults
from humaniflow_tpu.data.datasets import load_opt_initialise_data_from_pred_output as j_load_opt
from humaniflow_tpu.models import HumaniflowModel as JaxModel
from humaniflow_tpu.models import synthetic_smpl as j_synthetic_smpl
from humaniflow_tpu.ops.so3 import so3_exp as j_so3_exp
from humaniflow_tpu.ops.so3 import so3_log as j_so3_log
from humaniflow_tpu.pipelines.optimise import make_optimise_fn as jax_make_optimise_fn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# State: each tensor within 1e-4 of its largest |value|; loss terms rel 2e-4
# (docs/PARITY.md:40).  Loss gradient at the init: each tensor within 1e-3
# of its largest |value|, as the train step's gradients.  so3_exp's
# gradient: 1e-5 relative.  K7's twin against JAX's kernel: 1e-6 (the JAX
# test's tolerance); LBSSkin's backward against JAX's _lbs_bwd: 1e-5
# relative.
STATE_RTOL, LOSS_RTOL, GRAD_RTOL, SO3_GRAD_RTOL = 1e-4, 2e-4, 1e-3, 1e-5
LBS_ATOL, LBS_GRAD_RTOL = 1e-6, 1e-5
B, IMG, NV = 2, 64, 128
DIVERGE_LR = 1e30  # the first update is -LR·gradient, finite; the next overflows


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = small_cfgs(18)
    source = TorchModel(tcfg.MODEL, device="cpu", generator=torch.Generator().manual_seed(21))
    jm = JaxModel(jcfg.MODEL)
    jparams = jax_params_from_port(source, jm)
    tm = params_from_jax(jparams, TorchModel(tcfg.MODEL, device="cpu"))
    return jm, jparams, tm, j_synthetic_smpl(num_verts=NV), tsmpl.synthetic_smpl(num_verts=NV, device="cpu")


def _opt_cfgs(**kw):
    return tuple(dataclasses.replace(f(), NUM_ITERS=3, **kw) for f in (jax_opt_defaults, torch_opt_defaults))


@pytest.fixture(scope="module")
def jax_fns(setup):
    """JAX's optimise programs, built once (each traces and compiles)."""
    jm, _, _, jsmpl, _ = setup
    return {name: jax_make_optimise_fn(jm, jsmpl, _opt_cfgs(**kw)[0], img_wh=IMG)
            for name, kw in (("default", {}), ("diverge", {"LR": DIVERGE_LR}))}


def _init(seed, glob="rotmat", feat_dim=512):
    rng = np.random.default_rng(seed)
    rot = Rotation.random(B, random_state=seed)
    init = {
        "shape": rng.normal(scale=0.3, size=(B, 10)),
        "pose_axisangle": rng.normal(scale=0.2, size=(B, 23, 3)),
        "cam_wp": np.tile([0.9, 0.02, -0.05], (B, 1)),
        "input_feats": rng.normal(size=(B, feat_dim)),
        "joints2D": rng.uniform(4, IMG - 4, size=(B, 17, 2)),
        "joints2D_conf": rng.uniform(0.5, 1.0, size=(B, 17)),  # threshold 0.75: some appendages dropped
    }
    init["glob_rotmat" if glob == "rotmat" else "glob_axisangle"] = (
        rot.as_matrix() if glob == "rotmat" else rot.as_rotvec())
    return {k: np.asarray(v, np.float32) for k, v in init.items()}


def _run_both(setup, jax_fn, init, **cfg_kw):
    jm, jparams, tm, _, tsm = setup
    want = jax_fn(jparams, {k: jnp.asarray(v) for k, v in init.items()})
    got = t_optimise(tm, tsm, _opt_cfgs(**cfg_kw)[1], {k: t(v) for k, v in init.items()}, img_wh=IMG, device="cpu")
    return got, want


def _assert_losses(got, want):
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=LOSS_RTOL, err_msg=k)


@pytest.mark.parametrize("glob", ["rotmat", "axisangle"])
def test_optimise_matches_jax(setup, jax_fns, glob):
    init = _init(3, glob)
    got, want = _run_both(setup, jax_fns["default"], init)
    assert not bool(got["halted_on_nan"]) and not bool(want["halted_on_nan"])
    for k in ("pose_axisangle", "glob_axisangle", "shape", "cam_wp"):
        assert rel_err(got[k].numpy(), want[k]) <= STATE_RTOL, k
    assert float(np.abs(got["pose_axisangle"].numpy() - init["pose_axisangle"]).max()) > 1e-4  # it moved
    _assert_losses(got["initial_losses"], want["initial_losses"])
    _assert_losses(got["final_losses"], want["final_losses"])


def test_nan_target_freezes_both_at_the_init(setup, jax_fns):
    """A NaN target of an always-visible joint makes the first loss NaN:
    both loops halt at once and keep the init and the initial losses."""
    init = _init(4)
    init["joints2D"][1, 0, 0] = np.nan
    got, want = _run_both(setup, jax_fns["default"], init)
    assert bool(got["halted_on_nan"]) and bool(want["halted_on_nan"])
    np.testing.assert_array_equal(got["pose_axisangle"].numpy(), init["pose_axisangle"])
    np.testing.assert_array_equal(got["shape"].numpy(), init["shape"])
    assert rel_err(got["glob_axisangle"].numpy(), want["glob_axisangle"]) <= STATE_RTOL
    for k in want["final_losses"]:
        np.testing.assert_allclose(float(got["final_losses"][k]), float(want["final_losses"][k]), rtol=LOSS_RTOL,
                                   err_msg=k)
        np.testing.assert_array_equal(float(got["final_losses"][k]), float(got["initial_losses"][k]), err_msg=k)
    assert math.isnan(float(got["final_losses"]["joints2D"]))


def test_halt_after_a_finite_update_and_the_init_gradient(setup, jax_fns):
    """At LR = 1e30 the first update, −LR·∇loss(init), is finite and the
    second overflows: both loops halt with the state after the first update
    and report as final losses those of the first accepted iteration, taken
    at the init.  The first update also gives each side's loss gradient at
    the init, which reaches the state through the teacher-forced contexts
    too; they agree within GRAD_RTOL of each tensor's largest value."""
    init = _init(5)
    got, want = _run_both(setup, jax_fns["diverge"], init, LR=DIVERGE_LR)
    assert bool(got["halted_on_nan"]) and bool(want["halted_on_nan"])
    _assert_losses(got["final_losses"], want["final_losses"])
    _assert_losses(want["final_losses"], want["initial_losses"])
    _assert_losses(got["final_losses"], got["initial_losses"])
    starts = {"pose_axisangle": init["pose_axisangle"], "shape": init["shape"], "cam_wp": init["cam_wp"],
              "glob_axisangle": np.asarray(j_so3_log(jnp.asarray(init["glob_rotmat"])))}
    for k, start in starts.items():
        g_port = (start - got[k].numpy().astype(np.float64)) / DIVERGE_LR
        g_jax = (start - np.asarray(want[k], np.float64)) / DIVERGE_LR
        assert np.isfinite(g_port).all() and np.abs(g_jax).max() > 0, k
        assert rel_err(g_port, g_jax) <= GRAD_RTOL, (k, rel_err(g_port, g_jax))


@pytest.mark.parametrize("theta", [0.0, 1e-6, math.pi - 1e-4])
def test_so3_exp_gradient_matches_jax(theta):
    rng = np.random.default_rng(6)
    axes = rng.normal(size=(4, 3))
    v = (axes / np.linalg.norm(axes, axis=1, keepdims=True) * theta).astype(np.float32)
    w = rng.normal(size=(4, 3, 3)).astype(np.float32)
    want = np.asarray(jax.grad(lambda x: jnp.sum(j_so3_exp(x) * jnp.asarray(w)))(jnp.asarray(v)))
    x = t(v).requires_grad_(True)
    (got,) = torch.autograd.grad(torch.sum(t_so3_exp(x) * t(w)), x)
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=SO3_GRAD_RTOL, atol=SO3_GRAD_RTOL * np.abs(want).max())


def test_load_opt_initialise_data_matches_jax(tmp_path):
    """Dumps written by the port's save_pred_output, read by both loaders."""
    rng = np.random.default_rng(7)
    img_dir, pred_dir = tmp_path / "images", tmp_path / "pred"
    img_dir.mkdir()
    for name in ("b.jpg", "a.png", "notes.txt"):
        (img_dir / name).write_bytes(b"")
    f32 = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))  # noqa: E731
    pred = {"cam_wp": f32(2, 3), "glob_rotmat": f32(2, 3, 3), "shape_mode": f32(2, 10), "shape_log_std": f32(2, 10),
            "pose_axisangle_point_est": f32(2, 23, 3), "pose_rotmats_point_est": f32(2, 23, 3, 3),
            "input_feats": f32(2, 512)}
    extras = {"cropped_joints2D": f32(2, 17, 2), "hrnet_joints2D_conf": f32(2, 17), "bbox_centre": f32(2, 2)}
    save_pred_output(pred, ["a.png", "b.jpg"], str(pred_dir), extras=extras)
    got = t_load_opt(str(img_dir), str(pred_dir))
    want = j_load_opt(str(img_dir), str(pred_dir))
    assert got["fnames"] == want["fnames"] == ["a.png", "b.jpg"]
    assert set(got) == set(want)
    for k in want:
        if k != "fnames":
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(got["input_feats"], pred["input_feats"].numpy())


def test_optimise_cli_matches_jax_cli(setup, tmp_path, monkeypatch):
    """`python -m humaniflow_torch.cli.run_optimise --no_visualise` against
    JAX's scripts/run_optimise.py on one fabricated reference `.tar` and the
    same fabricated predict outputs: the `_opt.npz` files agree."""
    pytest.importorskip("cv2")
    import humaniflow_torch.models as TM
    import humaniflow_tpu.models as JM
    from humaniflow_torch.cli import run_optimise

    jm, jparams, _, _, _ = setup
    tar = str(tmp_path / "humaniflow_weights.tar")
    torch.save({"best_model_state_dict": _reference_humaniflow_state_dict(jparams, jm)}, tar)
    monkeypatch.setattr(JM, "load_smpl_npz", lambda *a, **k: j_synthetic_smpl(num_verts=NV))
    monkeypatch.setattr(TM, "load_smpl_npz", lambda *a, **k: tsmpl.synthetic_smpl(num_verts=NV, device=k["device"]))

    img_dir, pred_dir = tmp_path / "imgs", tmp_path / "pred"
    img_dir.mkdir()
    pred_dir.mkdir()
    init = _init(8)
    for i in range(B):
        (img_dir / f"im{i}.png").write_bytes(b"")
        np.savez(pred_dir / f"im{i}_pred.npz", shape_mode=init["shape"][i],
                 pose_axisangle_point_est=init["pose_axisangle"][i], glob_rotmat=init["glob_rotmat"][i],
                 cam_wp=init["cam_wp"][i], input_feats=init["input_feats"][i],
                 cropped_joints2D=init["joints2D"][i], hrnet_joints2D_conf=init["joints2D_conf"][i])
    cfg = tmp_path / "small.yaml"
    cfg.write_text(f"DATA:\n  PROXY_REP_SIZE: {IMG}\n")
    opt_cfg = tmp_path / "opt.yaml"
    opt_cfg.write_text("NUM_ITERS: 3\nLR: 0.0002\n")
    common = ["-I", str(img_dir), "-P", str(pred_dir), "-C", tar, "--cfg", str(cfg), "--optimise_cfg", str(opt_cfg),
              "--no_visualise"]
    run_optimise.main(common + ["-S", str(tmp_path / "port"), "--device", "cpu"])
    monkeypatch.syspath_prepend(os.path.join(REPO, "scripts"))
    jax_cli = importlib.import_module("run_optimise")
    monkeypatch.setattr(sys, "argv", ["run_optimise.py"] + common + ["-S", str(tmp_path / "jax")])
    jax_cli.main()
    for i in range(B):
        got, want = np.load(tmp_path / "port" / f"im{i}_opt.npz"), np.load(tmp_path / "jax" / f"im{i}_opt.npz")
        assert set(got.files) == set(want.files) == {"pose_axisangle", "shape", "cam_wp"}
        for k in want.files:
            assert rel_err(got[k], want[k]) <= STATE_RTOL, (i, k)
        assert np.abs(got["pose_axisangle"] - init["pose_axisangle"][i]).max() > 1e-6  # it moved


# ------------------------------------------------------------------- K7


def _lbs_inputs(b=5, v=300, seed=9):
    rng = np.random.default_rng(seed)
    w = rng.dirichlet(np.ones(24), size=v).astype(np.float32)
    a12 = rng.normal(scale=0.5, size=(b, 24, 12)).astype(np.float32)
    posed = rng.normal(size=(b, 3, v)).astype(np.float32)
    return w, a12, posed


def test_lbs_skin_twin_matches_jax_kernel_in_interpret_mode(monkeypatch):
    monkeypatch.setattr(jlbs.pl, "pallas_call", functools.partial(jlbs.pl.pallas_call, interpret=True))
    w, a12, posed = _lbs_inputs(b=37)
    want = np.asarray(jlbs.lbs_skin_pallas_cm(jnp.asarray(w), jnp.asarray(a12), jnp.asarray(posed)))
    got = cuda_lbs.lbs_skin_cm(t(w), t(a12), t(posed))  # on the CPU: the twin
    assert got.shape == (37, 3, 300)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=LBS_ATOL)
    np.testing.assert_array_equal(got.numpy(), cuda_lbs.lbs_skin_cm_plain(t(w), t(a12), t(posed)).numpy())


def test_lbs_skin_backward_matches_jax_lbs_bwd():
    w, a12, posed = _lbs_inputs()
    g = np.random.default_rng(10).normal(size=posed.shape).astype(np.float32)
    want = jlbs._lbs_bwd((jnp.asarray(w), jnp.asarray(a12), jnp.asarray(posed)), jnp.asarray(g))
    leaves = [t(a).requires_grad_(True) for a in (w, a12, posed)]
    out = cuda_lbs.LBSSkin.apply(*leaves)
    got = torch.autograd.grad(out, leaves, t(g))
    for name, a, b in zip(("dW", "da12", "dp"), got, want):
        assert rel_err(a.numpy(), b) <= LBS_GRAD_RTOL, name
    # only the inputs that need it: the posed vertices alone
    leaf = t(posed).requires_grad_(True)
    (dp,) = torch.autograd.grad(cuda_lbs.LBSSkin.apply(t(w), t(a12), leaf), [leaf], t(g))
    assert rel_err(dp.numpy(), want[2]) <= LBS_GRAD_RTOL
