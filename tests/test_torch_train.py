"""The port's training path against humaniflow_tpu on the CPU: flow inverses
and log-densities, the SO(3) flow log-prob, the loss, train-mode BatchNorm,
K2's gradient, one train step on the same weights, batch and noise, the
NaN rollback, the metrics tracker and the epoch loop with checkpoints.
K2's backward on the card: tests/test_torch_kernels.py."""

import copy
import dataclasses
import math
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from _torch_parity import IMG, jax_noise, jax_params_from_port, randomise_batchnorm, rel_err, small_cfgs, t
from scipy.spatial.transform import Rotation

from humaniflow_torch.flows import create_conditional_norm_flow as torch_flow
from humaniflow_torch.flows import spline as tspline
from humaniflow_torch.losses import humaniflow_loss as t_loss
from humaniflow_torch.metrics import TrainingLossesAndMetricsTracker as TorchTracker
from humaniflow_torch.models import HumaniflowModel as TorchModel
from humaniflow_torch.models import cuda_lbs
from humaniflow_torch.models import smpl as tsmpl
from humaniflow_torch.pipelines import make_optimizer, make_train_step
from humaniflow_torch.utils.convert_jax import jax_params_to_state_dict, params_from_jax
from humaniflow_tpu.flows import spline as jspline
from humaniflow_tpu.flows.factory import create_conditional_norm_flow as jax_flow
from humaniflow_tpu.losses.humaniflow_loss import humaniflow_loss as j_loss
from humaniflow_tpu.metrics.train_metrics import TrainingLossesAndMetricsTracker as JaxTracker
from humaniflow_tpu.models import HumaniflowModel as JaxModel
from humaniflow_tpu.models import smpl as jsmpl
from humaniflow_tpu.pipelines.train_step import make_train_step as jax_make_train_step

# Densities: rtol 2e-4 / atol 2e-3 (docs/PARITY.md:38).  Loss terms: rtol
# 2e-4 (docs/PARITY.md:40).  Train-mode BatchNorm: 1e-5 relative.  Gradients:
# each tensor within 1e-3 of its largest |value| (K2's explicit adjoints
# within 1e-5 of the largest).  Updated parameters: 2·LR absolute (Adam's
# first step moves a parameter by ~LR·sign(gradient), and a gradient that
# is float32 noise can take either sign), plus the rounding of the sum.  Tracker: rel 2e-4
# (docs/PARITY.md:35).
LP_RTOL, LP_ATOL = 2e-4, 2e-3
LOSS_RTOL = 2e-4
BN_RTOL = 1e-5
GRAD_RTOL = 1e-3
K2_GRAD_RTOL = 1e-5
B, NJ = 2, 2


# ------------------------------------------------------------------ flows


def _spline_inputs(seed=4, shape=(64, 2), k=8, bound=3.0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.3 * bound, 1.3 * bound, size=shape).astype(np.float32)
    w, h, l = (rng.normal(size=shape + (k,)).astype(np.float32) for _ in range(3))
    d = rng.normal(size=shape + (k - 1,)).astype(np.float32)
    return x, w, h, d, l


def test_spline_inverse_and_logdet_match_jax():
    args = _spline_inputs()
    x, ld = tspline.monotonic_rational_spline_inverse(*map(t, args), bound=3.0)
    jx, jld = jspline.monotonic_rational_spline(*map(jnp.asarray, args), inverse=True, bound=3.0)
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=LP_RTOL, atol=LP_ATOL)
    np.testing.assert_allclose(ld.numpy(), np.asarray(jld), rtol=LP_RTOL, atol=LP_ATOL)
    # the inverse undoes the forward inside the bound
    y = tspline.monotonic_rational_spline_forward(*map(t, args), bound=3.0)
    back, _ = tspline.monotonic_rational_spline_inverse(y, *map(t, args[1:]), bound=3.0)
    torch.testing.assert_close(back, t(args[0]), rtol=0, atol=1e-4)


def _flows(num_parts=5):
    radius = 1.5 * math.pi
    kw = dict(event_dim=3, context_dim=64, num_transforms=2, radial_tanh_radius=radius, base_dist_std=0.6,
              count_bins=8, bound=radius)
    jflow, tflow = jax_flow(**kw), torch_flow(num_parts=num_parts, **kw)
    jparams = jax.vmap(jflow.init)(jax.random.split(jax.random.PRNGKey(5), num_parts))
    state = {}
    for i in (1, 3):
        for k in range(4):
            layer = jparams[f"transform_{i}"]["hypernet"][f"layer_{k}"]
            state[f"transforms.{i}.hypernet.weights.{k}"] = t(np.asarray(layer["kernel"]).transpose(0, 2, 1))
            state[f"transforms.{i}.hypernet.biases.{k}"] = t(layer["bias"])
    tflow.load_state_dict(state)
    return jflow, jparams, tflow


def test_flow_log_prob_and_transform_inverses_match_jax():
    jflow, jparams, tflow = _flows()
    rng = np.random.default_rng(6)
    parts = (0, 2, 4)
    y = rng.normal(scale=1.5, size=(3, 4, len(parts), 3)).astype(np.float32)
    y[0, 0] = 0.0  # the radial tanh's small-norm branch
    y[0, 1, 0] = [4.7, 0.0, 0.0]  # next to the compact support's edge
    ctx = rng.normal(size=(3, 4, len(parts), 64)).astype(np.float32)
    sel = jax.tree_util.tree_map(lambda a: a[np.asarray(parts)], jparams)
    idx = torch.tensor(parts)
    want = np.asarray(jflow.log_prob(sel, jnp.asarray(y), jnp.asarray(ctx)))
    with torch.no_grad():
        got = tflow.log_prob(t(y), t(ctx), idx).numpy()
    np.testing.assert_allclose(got, want, rtol=LP_RTOL, atol=LP_ATOL)
    for i, (jt_, tt_) in enumerate(zip(jflow.transforms, tflow.transforms)):
        jx, jld = jt_.inverse(sel[f"transform_{i}"], jnp.asarray(y), jnp.asarray(ctx))
        with torch.no_grad():
            x, ld = tt_.inverse(t(y), t(ctx), idx)
        np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=LP_RTOL, atol=LP_ATOL, err_msg=str(i))
        np.testing.assert_allclose(ld.numpy(), np.asarray(jld), rtol=LP_RTOL, atol=LP_ATOL, err_msg=str(i))


# ----------------------------------------------------------------- models


def _pair():
    """(JAX model, JAX params with random BatchNorm, port model, port cfg,
    JAX cfg) at IMG² with NUM_J2D_SAMPLES = NJ."""
    jcfg, tcfg = small_cfgs(18)
    for cfg in (jcfg, tcfg):
        cfg.LOSS = dataclasses.replace(cfg.LOSS, NUM_J2D_SAMPLES=NJ)
    source = TorchModel(tcfg.MODEL, device="cpu", generator=torch.Generator().manual_seed(11))
    randomise_batchnorm(source)
    jm = JaxModel(jcfg.MODEL)
    jparams = jax_params_from_port(source, jm)
    tm = TorchModel(tcfg.MODEL, device="cpu", generator=torch.Generator().manual_seed(99))
    params_from_jax(jparams, tm)
    return jm, jparams, tm, tcfg, jcfg


@pytest.fixture(scope="module")
def pair():
    return _pair()


def _rotations(n, seed, near_pi=0):
    rng = np.random.default_rng(seed)
    v = rng.normal(scale=0.6, size=(n, 3))
    if near_pi:
        axes = rng.normal(size=(near_pi, 3))
        axes /= np.linalg.norm(axes, axis=1, keepdims=True)
        v[:near_pi] = axes * (math.pi - 10.0 ** rng.uniform(-6, -1.5, near_pi))[:, None]
    return Rotation.from_rotvec(v).as_matrix().astype(np.float32)


def test_so3_flow_log_prob_matches_jax_near_pi(pair):
    jm, jparams, tm, _, _ = pair
    rng = np.random.default_rng(7)
    r = _rotations(4 * 23, seed=8, near_pi=20).reshape(4, 23, 3, 3)
    ctx = jax.nn.elu(rng.normal(size=(4, 23, 64)).astype(np.float32))
    want = np.asarray(jm.pose_log_prob(jparams, jnp.asarray(r), jnp.asarray(ctx)))
    with torch.no_grad():
        got = tm.pose_log_prob(t(r), t(np.asarray(ctx))).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=LP_RTOL, atol=LP_ATOL)


def _batch(seed=0, b=B):
    """A training batch as numpy arrays (proxy, targets, 2D joints in pixels)."""
    rng = np.random.default_rng(seed)
    vis = rng.uniform(size=(b, 17)) > 0.2
    return {
        "proxy": rng.uniform(size=(b, IMG, IMG, 18)).astype(np.float32),
        "pose_rotmats": _rotations(b * 23, seed + 1).reshape(b, 23, 3, 3),
        "glob_rotmats": _rotations(b, seed + 2),
        "shape": rng.normal(size=(b, 10)).astype(np.float32),
        "joints2D": rng.uniform(0, IMG, size=(b, 17, 2)).astype(np.float32),
        "joints2D_vis": vis.astype(np.float32),
    }


def test_loss_matches_jax(pair):
    _, _, _, tcfg, jcfg = pair
    rng = np.random.default_rng(9)
    bt = _batch(3)
    pred = {
        "pose_log_probs": rng.normal(size=(B, 23)).astype(np.float32),
        "shape_mode": rng.normal(size=(B, 10)).astype(np.float32),
        "shape_log_std": rng.normal(scale=0.3, size=(B, 10)).astype(np.float32),
        "joints2D": rng.uniform(-1, 1, size=(B, 1 + NJ, 17, 2)).astype(np.float32),
        "glob_rotmats": _rotations(B, 10),
    }
    target = {"shape_params": bt["shape"], "joints2D": bt["joints2D"], "joints2D_vis": bt["joints2D_vis"],
              "glob_rotmats": bt["glob_rotmats"]}
    jtot, jb = j_loss(jcfg.LOSS, IMG, {k: jnp.asarray(v) for k, v in pred.items()},
                      {k: jnp.asarray(v) for k, v in target.items()})
    ttot, tb = t_loss(tcfg.LOSS, IMG, {k: t(v) for k, v in pred.items()}, {k: t(v) for k, v in target.items()})
    assert set(tb) == set(jb)
    for k in jb:
        np.testing.assert_allclose(float(tb[k]), float(jb[k]), rtol=LOSS_RTOL, err_msg=k)


def test_train_mode_batchnorm_matches_flax(pair):
    jm, jparams, tm, _, _ = pair
    tm = copy.deepcopy(tm)
    x = _batch(4)["proxy"]
    feats, mutated = jm.encoder.apply(jparams["encoder"], jnp.asarray(x), train=True, mutable=["batch_stats"])
    with torch.no_grad():
        out = tm.apply(t(x), train=True, return_input_feats=True)
    assert rel_err(out["input_feats"].numpy(), feats) < 2e-4  # 20 convolutions in another order, as in eval mode
    want_stats = jax_params_to_state_dict({"encoder": {"batch_stats": jax.tree_util.tree_map(np.asarray,
                                                                                           mutated["batch_stats"])}})
    assert set(out["encoder_batch_stats"]) == set(want_stats)
    for k, v in want_stats.items():
        assert rel_err(out["encoder_batch_stats"][k].numpy(), v.numpy()) <= BN_RTOL, k
    assert not tm.encoder.training


def test_fused_level_refuses_grad_mode(pair, monkeypatch):
    """K5 has no backward: under grad mode the fused route is not taken, even
    with the JAX package's switch HFT_FUSED_LEVEL=1 set, and the pass runs
    the eager flow, whose samples carry a gradient to the flow's weights."""
    from humaniflow_torch.flows import cuda_level

    _, _, tm, _, _ = pair
    monkeypatch.setenv("HFT_FUSED_LEVEL", "1")
    calls = []
    monkeypatch.setattr(cuda_level, "flow_forward_level", lambda *a: calls.append(a))
    assert not tm._fused_level_enabled()
    out = tm.apply(t(_batch(5)["proxy"]), num_samples=2, generator=torch.Generator().manual_seed(0))
    assert calls == [] and out["pose_rotmats_samples"].requires_grad


# ------------------------------------------------------------ K2 gradient


def _k2_args(v=500, b=3, seed=0, dtype=torch.float32):
    smpl = tsmpl.synthetic_smpl(num_verts=v, device="cpu")
    rng = np.random.default_rng(seed)
    betas = t(rng.normal(size=(b, 10)).astype(np.float32))
    rots = torch.from_numpy(_rotations(b * 24, seed + 1).reshape(b, 24, 3, 3))
    _, a12, pf = tsmpl._kernel_inputs(smpl, betas, rots[:, 1:], rots[:, 0])
    model = (smpl.v_template_cm, smpl.shapedirs_cm, smpl.posedirs_cm, smpl.lbs_weights)
    return [a.to(dtype).detach().clone().requires_grad_(True) for a in (a12, betas, pf) + model]


def test_k2_backward_matches_autograd_of_the_twin():
    args = _k2_args()
    g = torch.randn(3, 3, 500, generator=torch.Generator().manual_seed(1))
    got = torch.autograd.grad(cuda_lbs.smpl_verts_differentiable(*args), args, g)
    want = torch.autograd.grad(cuda_lbs.smpl_verts_plain(*args), args, g)
    for i, (a, w) in enumerate(zip(got, want)):
        assert rel_err(a.numpy(), w.numpy()) <= K2_GRAD_RTOL, i
    # only the inputs that need a gradient get one
    part = [a.detach().requires_grad_(i in (0, 1, 2)) for i, a in enumerate(args)]
    out = cuda_lbs.smpl_verts_differentiable(*part)
    assert out.grad_fn is not None
    grads = cuda_lbs.smpl_verts_backward(g, [a.requires_grad for a in part], *part)
    assert all((gr is None) == (not a.requires_grad) for gr, a in zip(grads, part))


def test_k2_gradcheck_float64():
    args = _k2_args(v=10, b=2, dtype=torch.float64)
    assert torch.autograd.gradcheck(cuda_lbs.SMPLVerts.apply, args, eps=1e-6, atol=1e-6)


def test_smpl_forward_vjp_matches_jax():
    v, b = 6890, 2
    tm_smpl = tsmpl.synthetic_smpl(num_verts=v, device="cpu")
    jm_smpl = jsmpl.synthetic_smpl(num_verts=v)
    rng = np.random.default_rng(12)
    betas = rng.normal(size=(b, 10)).astype(np.float32)
    pose = _rotations(b * 23, 13).reshape(b, 23, 3, 3)
    glob = _rotations(b, 14)
    gv = rng.normal(size=(b, v, 3)).astype(np.float32)
    gj = rng.normal(size=(b, 90, 3)).astype(np.float32)

    def jf(be, po, gl):
        out = jsmpl.smpl_forward(jm_smpl, be, po, gl)
        return out["vertices"], out["joints"]

    _, vjp = jax.vjp(jf, jnp.asarray(betas), jnp.asarray(pose), jnp.asarray(glob))
    want = vjp((jnp.asarray(gv), jnp.asarray(gj)))
    targs = [t(a).requires_grad_(True) for a in (betas, pose, glob)]
    out = tsmpl.smpl_forward(tm_smpl, *targs)
    got = torch.autograd.grad((out["vertices"], out["joints"]), targs, (t(gv), t(gj)))
    for name, a, w in zip(("betas", "body_pose", "global_orient"), got, want):
        assert rel_err(a.numpy(), w) <= K2_GRAD_RTOL * 10, name


# ------------------------------------------------------------- train step


def _capture_grads():
    """An optax transformation that leaves the parameters alone and returns
    the gradients as its new state."""
    return optax.GradientTransformation(lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
                                        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g))


@pytest.fixture(scope="module")
def jax_step(pair):
    """JAX's train step on the shared batch and key: (metrics, gradients,
    params after one optax.adam step, new BatchNorm running stats)."""
    jm, jparams, _, _, jcfg = pair
    smpl = jsmpl.synthetic_smpl(num_verts=6890)
    capture = _capture_grads()
    step = jax.jit(jax_make_train_step(jm, smpl, jcfg.LOSS, capture, img_wh=IMG))
    batch = {k: jnp.asarray(v) for k, v in _batch(20).items()}
    out_params, grads, metrics = step(jparams, capture.init(jparams), batch, jax.random.PRNGKey(21))
    adam = optax.adam(jcfg.TRAIN.LR)
    updates, _ = adam.update(grads, adam.init(jparams), jparams)
    adam_params = optax.apply_updates(jparams, updates)
    tree = lambda x: jax.tree_util.tree_map(np.asarray, x)  # noqa: E731
    return tree(metrics), tree(grads), tree(adam_params), tree(out_params["encoder"]["batch_stats"])


def _port_step(pair, batch_seed=20, **kw):
    jm, _, tm, tcfg, _ = pair
    tm = copy.deepcopy(tm)
    smpl = tsmpl.synthetic_smpl(num_verts=6890, device="cpu")
    opt = make_optimizer(tm, tcfg)
    step = make_train_step(tm, smpl, tcfg.LOSS, opt, img_wh=IMG, **kw)
    shape_noise, levels = jax_noise(jm, jax.random.PRNGKey(21), B, NJ)
    noise = (t(shape_noise), [t(z) for z in levels])
    return tm, opt, step, {k: t(v) for k, v in _batch(batch_seed).items()}, noise


def test_train_step_matches_jax(pair, jax_step):
    jmetrics, jgrads, jadam, jbn = jax_step
    tm, opt, step, batch, noise = _port_step(pair)
    named = dict(tm.named_parameters())
    before = {k: v.detach().clone() for k, v in named.items()}
    metrics = step(batch, noise=noise)
    assert float(metrics["nan_skipped"]) == 0.0
    for k in ("pose_nll", "shape_nll", "joints2D", "glob_rotmats", "total"):
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), rtol=LOSS_RTOL, err_msg=k)
    np.testing.assert_allclose(float(metrics["grad_norm"]), float(jmetrics["grad_norm"]), rtol=1e-3)

    want_grads = jax_params_to_state_dict(jgrads)
    want_params = jax_params_to_state_dict(jadam)
    lr = pair[3].TRAIN.LR
    assert set(named) <= set(want_grads)
    worst = {}
    for k, p in named.items():
        g, w = p.grad.numpy(), want_grads[k].numpy()
        worst[k] = float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-30))
        assert worst[k] <= GRAD_RTOL, (k, worst[k])
        assert float((p.detach() - want_params[k]).abs().max()) <= 2 * lr + 1e-7, k  # + the parameter's rounding
        assert not torch.equal(p.detach(), before[k]) or not bool(w.any()), k
    print(f"\nworst gradient error relative to each tensor's largest: {max(worst.values()):.3e} "
          f"({max(worst, key=worst.get)})")
    want_bn = jax_params_to_state_dict({"encoder": {"batch_stats": jbn}})
    for k, v in want_bn.items():
        assert rel_err(tm.state_dict()[k].numpy(), v.numpy()) <= BN_RTOL, k


def _state(tm, opt):
    out = {f"param:{k}": v.detach().clone() for k, v in tm.state_dict().items()}
    for i, (p, s) in enumerate(opt.state.items()):
        for k, v in s.items():
            out[f"adam:{i}:{k}"] = v.detach().clone()
    return out


@pytest.mark.parametrize("after_a_step", [False, True])
def test_train_step_rolls_back_on_nan(pair, after_a_step):
    tm, opt, step, batch, noise = _port_step(pair)
    if after_a_step:
        assert float(step(batch, noise=noise)["nan_skipped"]) == 0.0
    before = _state(tm, opt)
    bad = dict(batch)
    bad["proxy"] = batch["proxy"].clone()
    bad["proxy"][0, 3, 5, 2] = float("nan")
    metrics = step(bad, noise=noise)
    assert float(metrics["nan_skipped"]) == 1.0
    assert not math.isfinite(float(metrics["grad_norm"])) or not math.isfinite(float(metrics["total"]))
    after = _state(tm, opt)
    assert set(after) == set(before)
    for k in before:
        assert torch.equal(after[k], before[k]), k


def test_validation_step_leaves_state_alone(pair):
    tm, opt, step, batch, noise = _port_step(pair, emit_metric_tensors=True)
    before = _state(tm, opt)
    metrics = step(batch, noise=noise, update=False)
    assert math.isfinite(float(metrics["total"])) and "metric_tensors" in metrics
    assert metrics["metric_tensors"]["pred_verts3D"].shape == (B, 6890, 3)
    after = _state(tm, opt)
    for k in before:
        assert torch.equal(after[k], before[k]), k


# ---------------------------------------------------------------- tracker


def test_tracker_matches_jax(tmp_path):
    rng = np.random.default_rng(30)
    metrics = ("PVE", "PVE-SC", "MPJPE", "MPJPE-PA", "joints2D-L2E")
    trackers = {"jax": JaxTracker(metrics, IMG, log_save_path=str(tmp_path / "j.pkl")),
                "torch": TorchTracker(metrics, IMG, log_save_path=str(tmp_path / "t.pkl"))}
    best = {"jax": {"PVE-SC": np.inf}, "torch": {"PVE-SC": np.inf}}
    decisions = {"jax": [], "torch": []}
    for epoch in range(3):
        for tr in trackers.values():
            tr.initialise_loss_metric_sums()
        for split in ("train", "val", "val"):
            pred = {"verts3D": rng.normal(size=(B, 6890, 3)), "joints3D": rng.normal(size=(B, 14, 3)),
                    "joints2D": rng.uniform(-1, 1, size=(B, 17, 2))}
            target = {"verts3D": rng.normal(size=(B, 6890, 3)), "joints3D": rng.normal(size=(B, 14, 3)),
                      "joints2D": rng.uniform(0, IMG, size=(B, 17, 2)),
                      "joints2D_vis": (rng.uniform(size=(B, 17)) > 0.3).astype(np.float32)}
            loss = float(rng.uniform(1, 10))
            f32 = lambda d, conv: {k: conv(v.astype(np.float32)) for k, v in d.items()}  # noqa: E731
            jv = jax.device_get(trackers["jax"].batch_sums_device(jnp.float32(loss), f32(pred, jnp.asarray),
                                                                  f32(target, jnp.asarray)))
            tv = trackers["torch"].batch_sums_device(torch.tensor(loss), f32(pred, t), f32(target, t))
            tv = {"loss": float(tv["loss"]), "sums": {k: float(v) for k, v in tv["sums"].items()},
                  "j2d_unmasked": float(tv["j2d_unmasked"])}
            trackers["jax"].add_batch_sums(split, jv, B)
            trackers["torch"].add_batch_sums(split, tv, B)
        for name, tr in trackers.items():
            tr.update_per_epoch()
            keep = tr.determine_save_model_weights_this_epoch(("PVE-SC",), best[name])
            decisions[name].append(keep)
            if keep:
                best[name]["PVE-SC"] = tr.epochs_history["val_PVE-SC"][-1]
    assert decisions["jax"] == decisions["torch"]
    hj, ht = trackers["jax"].epochs_history, trackers["torch"].epochs_history
    assert set(hj) == set(ht)
    for k in hj:
        np.testing.assert_allclose(ht[k], hj[k], rtol=2e-4, err_msg=k)
    with open(tmp_path / "t.pkl", "rb") as f:
        assert pickle.load(f)["val_PVE"] == ht["val_PVE"]
    resumed = TorchTracker(metrics, IMG, log_save_path=str(tmp_path / "t.pkl"), load_logs=True, current_epoch=2)
    assert resumed.epochs_history["train_losses"] == ht["train_losses"][:2]


# -------------------------------------------------------------- epoch loop


class _FakeDataset:
    """epoch_batches provider of poses, textures and backgrounds."""

    def __init__(self, n=2, img=IMG, seed=0):
        self.rng = np.random.default_rng(seed)
        self.n, self.img = n, img

    def __len__(self):
        return self.n

    def epoch_batches(self, batch_size, shuffle=True, drop_last=True):
        for _ in range(self.n // batch_size):
            yield {
                "pose": self.rng.normal(scale=0.3, size=(batch_size, 72)).astype(np.float32),
                "texture": self.rng.uniform(size=(batch_size, 1200, 800, 3)).astype(np.float32),
                "background": self.rng.uniform(size=(batch_size, self.img, self.img, 3)).astype(np.float32),
            }


def test_train_humaniflow_two_epochs_checkpoint_and_resume(pair, tmp_path):
    from humaniflow_torch.pipelines import train_humaniflow
    from humaniflow_torch.render import TexturedIUVRenderer
    from humaniflow_torch.utils.checkpoints import load_checkpoint

    _, _, tm, tcfg, _ = pair
    tm = copy.deepcopy(tm)
    cfg = copy.deepcopy(tcfg)
    cfg.TRAIN = dataclasses.replace(cfg.TRAIN, BATCH_SIZE=B, EPOCHS_PER_SAVE=1, SYNTH_DATA=dataclasses.replace(
        cfg.TRAIN.SYNTH_DATA, FOCAL_LENGTH=300.0 * IMG / 256.0))
    smpl = tsmpl.synthetic_smpl(num_verts=6890, device="cpu")
    renderer = TexturedIUVRenderer(img_wh=IMG, projection_type="perspective",
                                   focal_length=cfg.TRAIN.SYNTH_DATA.FOCAL_LENGTH, chunk=4096, emit_overflow=True,
                                   device="cpu")
    before = tm.fc1.weight.detach().clone()
    exp = str(tmp_path / "exp")
    kw = dict(metrics_to_track=("PVE", "joints2D-L2E"), save_val_metrics=("PVE",), steps_per_epoch=1)
    params, best = train_humaniflow(tm, smpl, cfg, renderer, _FakeDataset(), _FakeDataset(seed=1), exp,
                                    num_epochs=2, generator=torch.Generator().manual_seed(0), **kw)
    assert os.path.exists(os.path.join(exp, "log.pkl"))
    ckpt = load_checkpoint(os.path.join(exp, "epoch_000001"))
    assert ckpt["epoch"] == 1 and set(ckpt) == {"epoch", "best_epoch", "best_epoch_val_metrics", "params",
                                                "best_params", "opt_state"}
    assert float((params["fc1.weight"] - before).abs().max()) > 0
    torch.testing.assert_close(ckpt["params"]["fc1.weight"], params["fc1.weight"], rtol=0, atol=0)
    with open(os.path.join(exp, "log.pkl"), "rb") as f:
        first = pickle.load(f)
    assert len(first["train_losses"]) == 2 and all(math.isfinite(x) for x in first["val_PVE"] + first["val_losses"])

    # resume from epoch 1 for one more epoch
    resumed = copy.deepcopy(pair[2])
    params3, _ = train_humaniflow(resumed, smpl, cfg, renderer, _FakeDataset(seed=2), _FakeDataset(seed=3), exp,
                                  num_epochs=3, resume_state=ckpt, generator=torch.Generator().manual_seed(1), **kw)
    with open(os.path.join(exp, "log.pkl"), "rb") as f:
        history = pickle.load(f)
    assert len(history["train_losses"]) == 3 and history["train_losses"][:2] == first["train_losses"]
    assert load_checkpoint(os.path.join(exp, "epoch_000002"))["epoch"] == 2
    assert float((params3["fc1.weight"] - params["fc1.weight"]).abs().max()) > 0
