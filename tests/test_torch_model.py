"""humaniflow_torch ResNet encoder and HumaniflowModel.apply against
humaniflow_tpu on the CPU, with weights carried across by params_from_jax
and the JAX model's own noise handed to the port."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import (
    IMG,
    jax_noise,
    jax_params_from_port,
    randomise_batchnorm,
    rel_err,
    small_cfgs,
    t,
)

from humaniflow_torch.models import HumaniflowModel as TorchModel
from humaniflow_torch.utils.convert_jax import params_from_jax
from humaniflow_tpu.models import HumaniflowModel as JaxModel

# ResNet features: 2e-4 relative (20 convolutions summed in another order).
RESNET_RTOL = 2e-4
# Whole-model outputs with shared noise: 5e-4 (the encoder's error carried
# through heads and 8 flow levels).
MODEL_ATOL = 5e-4
# The fused pass's sample 0 against the separate point-estimate pass.
SAMPLE0_ATOL = 2e-6
B, N = 2, 4


def _pair(num_resnet_layers=18):
    """(jax model, jax params, port model loaded from those params)."""
    jcfg, tcfg = small_cfgs(num_resnet_layers)
    source = TorchModel(tcfg.MODEL, device="cpu", generator=torch.Generator().manual_seed(11))
    randomise_batchnorm(source)
    jm = JaxModel(jcfg.MODEL)
    jparams = jax_params_from_port(source, jm)
    tm = TorchModel(tcfg.MODEL, device="cpu", generator=torch.Generator().manual_seed(99))
    params_from_jax(jparams, tm)
    return jm, jparams, tm


@pytest.fixture(scope="module")
def pair():
    return _pair(18)


def _proxy(seed=0, img=IMG):
    return np.random.default_rng(seed).uniform(size=(B, img, img, 18)).astype(np.float32)


@pytest.mark.parametrize("layers", [18, 50])
def test_resnet_features_match_jax(layers, pair):
    jm, jparams, tm = pair if layers == 18 else _pair(50)
    x = _proxy(1, IMG if layers == 18 else IMG // 2)
    want = np.asarray(jm.encoder.apply(jparams["encoder"], jnp.asarray(x), train=False))
    with torch.no_grad():
        got = tm.encoder(t(x)).numpy()
    assert got.shape == (B, 512 if layers == 18 else 2048)
    assert rel_err(got, want) < RESNET_RTOL


def test_apply_matches_jax_with_shared_noise(pair):
    """Sampled shapes and poses (predict's shape-mode samples are covered by
    test_torch_predict.py)."""
    jm, jparams, tm = pair
    shape_mode_samples = False
    x = _proxy(2)
    key = jax.random.PRNGKey(3)
    fn = jax.jit(
        lambda p, x, k: jm.apply(
            p, x, key=k, num_samples=N, use_shape_mode_for_samples=shape_mode_samples,
            return_input_feats=True,
        )
    )
    want = fn(jparams, jnp.asarray(x), key)
    shape_noise, levels = jax_noise(jm, key, B, N)
    with torch.no_grad():
        got = tm.apply(
            t(x), num_samples=N, use_shape_mode_for_samples=shape_mode_samples,
            return_input_feats=True, base_noise=[t(z) for z in levels], shape_noise=t(shape_noise),
        )
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=MODEL_ATOL, rtol=0, err_msg=k)


def test_sample0_is_the_mode(pair):
    """The fused (B, N+1) pass's point estimate equals the separate
    zero-noise pass (so that pass matches JAX too), and drawing from a
    generator is reproducible."""
    _, _, tm = pair
    x = t(_proxy(5))
    with torch.no_grad():
        mode = tm.apply(x)
        fused = tm.apply(x, num_samples=N, generator=torch.Generator().manual_seed(0))
        again = tm.apply(x, num_samples=N, generator=torch.Generator().manual_seed(0))
    for k in ("pose_axisangle_point_est", "pose_rotmats_point_est"):
        torch.testing.assert_close(fused[k], mode[k], rtol=0, atol=SAMPLE0_ATOL)
    torch.testing.assert_close(fused["pose_rotmats_samples"], again["pose_rotmats_samples"], rtol=0, atol=0)
    assert fused["pose_rotmats_samples"].shape == (B, N, 23, 3, 3)


def test_apply_needs_noise_for_samples(pair):
    _, _, tm = pair
    with pytest.raises(ValueError):
        tm.apply(t(_proxy(6)), num_samples=N)


def test_params_from_jax_rejects_mismatches(pair):
    jm, jparams, tm = pair
    broken = jax.tree_util.tree_map(lambda a: a, jparams)
    del broken["fc_cam"]
    with pytest.raises(KeyError):
        params_from_jax(broken, tm)
    broken = jax.tree_util.tree_map(lambda a: a, jparams)
    broken["fc_cam"]["bias"] = np.zeros(4, np.float32)
    with pytest.raises(ValueError):
        params_from_jax(broken, tm)
