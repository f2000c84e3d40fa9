"""Helpers shared by the tests that hold humaniflow_torch against
humaniflow_tpu on the CPU: weights carried between the two packages and
the JAX model's own noise draws, so both sides see the same numbers."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from humaniflow_torch.utils.convert_jax import port_key

IMG = 64  # proxy side length for the parity tests


def small_cfgs(num_resnet_layers: int = 18):
    """(JAX config, port config) with a 64×64 proxy, otherwise the defaults."""
    from humaniflow_tpu.configs import get_humaniflow_cfg_defaults as jax_defaults

    from humaniflow_torch.configs import get_humaniflow_cfg_defaults as torch_defaults

    out = []
    for cfg in (jax_defaults(), torch_defaults()):
        cfg.DATA = dataclasses.replace(cfg.DATA, PROXY_REP_SIZE=IMG)
        cfg.MODEL = dataclasses.replace(cfg.MODEL, NUM_RESNET_LAYERS=num_resnet_layers)
        out.append(cfg)
    return tuple(out)


def randomise_batchnorm(model: torch.nn.Module, seed: int = 0):
    """Give every BatchNorm non-trivial affine weights and running stats, so
    that a layout error in carrying them across shows."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                c = m.num_features
                m.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32)))
                m.bias.copy_(torch.from_numpy(rng.normal(0, 0.1, c).astype(np.float32)))
                m.running_mean.copy_(torch.from_numpy(rng.normal(0, 0.1, c).astype(np.float32)))
                m.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32)))


def jax_params_from_port(port_model, jax_model, input_shape=(1, IMG, IMG, 18)):
    """The JAX parameter pytree (numpy leaves) holding the port model's
    weights, built on the structure of jax_model.init (traced, not run)."""
    shapes = jax.eval_shape(lambda k: jax_model.init(k, input_shape), jax.random.PRNGKey(0))
    state = port_model.state_dict()

    def leaf(path, sd):
        key, perm = port_key(tuple(p.key for p in path), len(sd.shape))
        a = state[key].detach().cpu().numpy()
        if perm is not None:
            a = a.transpose(np.argsort(perm))
        assert a.shape == sd.shape, (key, a.shape, sd.shape)
        return np.ascontiguousarray(a)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def random_hrnet_variables(flax_hrnet, input_shape=(1, 96, 64, 3), seed: int = 0, kernel_scale: float = 1.0,
                           random_batchnorm: bool = True):
    """Flax HRNet variables (numpy leaves) on the structure of
    flax_hrnet.init (traced, not run): LeCun-normal kernels times
    kernel_scale; with random_batchnorm, small random biases and non-trivial
    BatchNorm affine weights and running statistics, else zero biases and
    identity BatchNorm."""
    shapes = jax.eval_shape(lambda k: flax_hrnet.init(k, jnp.zeros(input_shape), train=False), jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def leaf(path, sd):
        name, shape = path[-1].key, sd.shape
        if name == "kernel":
            a = rng.normal(0.0, kernel_scale * float(np.prod(shape[:-1])) ** -0.5, shape)
        elif name in ("scale", "var"):
            a = rng.uniform(0.5, 1.5, shape) if random_batchnorm else np.ones(shape)
        else:  # bias, mean
            a = rng.normal(0.0, 0.1, shape) if random_batchnorm else np.zeros(shape)
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def jax_noise(jax_model, key, b: int, n: int, n_betas: int = 10):
    """(shape noise (B, N, nb), per-level pose noise [(B, N, P, 3)]) exactly
    as HumaniflowModel.apply draws them from `key`."""
    key_shape, key_pose = jax.random.split(key)
    level_keys = jax.random.split(key_pose, len(jax_model.levels))
    levels = [
        np.asarray(jax.random.normal(level_keys[i], (b, n, len(p), 3), jnp.float32))
        for i, p in enumerate(jax_model.levels)
    ]
    shape = np.asarray(jax.random.normal(key_shape, (b, n, n_betas)))
    return shape, levels


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-12))
