"""One train step with flow BatchNorm (affine coupling, conditional linear
PLU) against humaniflow_tpu's make_train_step on the CPU: the same weights,
batch and noise give the same losses and gradients, and the running
statistics, stepped by Adam and then moved towards the batch, agree.  The
JAX model's flow runs part by part (tests/_torch_parity.py::PerPartFlow)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch
from _torch_parity import IMG, jax_noise, menu_model_pair, rel_err, t
from scipy.spatial.transform import Rotation

from humaniflow_torch.models import smpl as tsmpl
from humaniflow_torch.pipelines import make_optimizer, make_train_step
from humaniflow_torch.utils.convert_jax import jax_params_to_state_dict
from humaniflow_tpu.models import smpl as jsmpl
from humaniflow_tpu.pipelines.train_step import make_train_step as jax_make_train_step

# As tests/test_torch_train.py::test_train_step_matches_jax: loss terms rel
# 2e-4, each gradient within 1e-3 of its tensor's largest.  Running
# statistics after the step: 1e-5.
LOSS_RTOL = 2e-4
GRAD_RTOL = 1e-3
BN_TOL = 1e-5
B, NJ = 2, 2  # as tests/test_torch_train.py


def _rotations(n, seed):
    v = np.random.default_rng(seed).normal(scale=0.6, size=(n, 3))
    return Rotation.from_rotvec(v).as_matrix().astype(np.float32)


def _batch(seed=20):
    rng = np.random.default_rng(seed)
    return {
        "proxy": rng.uniform(size=(B, IMG, IMG, 18)).astype(np.float32),
        "pose_rotmats": _rotations(B * 23, seed + 1).reshape(B, 23, 3, 3),
        "glob_rotmats": _rotations(B, seed + 2),
        "shape": rng.normal(size=(B, 10)).astype(np.float32),
        "joints2D": rng.uniform(0, IMG, size=(B, 17, 2)).astype(np.float32),
        "joints2D_vis": (rng.uniform(size=(B, 17)) > 0.2).astype(np.float32),
    }


def _record_grads():
    """An optax transformation that passes the updates on and keeps the
    gradients as its state."""
    return optax.GradientTransformation(lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
                                        lambda g, s, p=None: (g, g))


def test_batchnorm_train_step_matches_jax():
    jm, jparams, tm, tcfg, jcfg = menu_model_pair("affine_coupling", "conditional_linear_plu", True,
                                                  num_j2d_samples=NJ)
    opt = optax.chain(_record_grads(), optax.adam(jcfg.TRAIN.LR))
    step = jax.jit(jax_make_train_step(jm, jsmpl.synthetic_smpl(num_verts=6890), jcfg.LOSS, opt, img_wh=IMG))
    batch = _batch()
    key = jax.random.PRNGKey(21)
    out_params, opt_state, jmetrics = step(jparams, opt.init(jparams), {k: jnp.asarray(v) for k, v in batch.items()},
                                           key)
    tree = lambda x: jax.tree_util.tree_map(np.asarray, x)  # noqa: E731
    want_grads = jax_params_to_state_dict(tree(opt_state[0]))
    want_params = jax_params_to_state_dict(tree(out_params))

    topt = make_optimizer(tm, tcfg)
    tstep = make_train_step(tm, tsmpl.synthetic_smpl(num_verts=6890, device="cpu"), tcfg.LOSS, topt, img_wh=IMG)
    shape_noise, levels = jax_noise(jm, key, B, NJ)
    stats = {k: p for k, p in tm.named_parameters() if k.endswith(("moving_mean", "moving_var"))}
    before = {k: p.detach().clone() for k, p in stats.items()}
    metrics = tstep({k: t(v) for k, v in batch.items()}, noise=(t(shape_noise), [t(z) for z in levels]))
    assert float(metrics["nan_skipped"]) == 0.0 == float(jmetrics["nan_skipped"])
    for k in ("pose_nll", "shape_nll", "joints2D", "glob_rotmats", "total"):
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), rtol=LOSS_RTOL, err_msg=k)
    worst = {}
    for k, p in tm.named_parameters():
        w = want_grads[k].numpy()
        worst[k] = float(np.abs(p.grad.numpy() - w).max() / max(np.abs(w).max(), 1e-30))
    for k, v in worst.items():
        assert v <= GRAD_RTOL, (k, v)
    assert len(stats) == 4  # two blocks' moving_mean and moving_var
    for k, p in stats.items():
        got = p.detach().numpy()
        assert rel_err(got, want_params[k].numpy()) <= BN_TOL, k
        assert not torch.equal(p.detach(), before[k]), k
