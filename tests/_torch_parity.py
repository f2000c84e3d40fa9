"""Helpers shared by the tests that hold humaniflow_torch against
humaniflow_tpu on the CPU: weights carried between the two packages and
the JAX model's own noise draws, so both sides see the same numbers."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch
from threadpoolctl import threadpool_limits

from humaniflow_torch.utils.convert_jax import port_key

IMG = 64  # proxy side length for the parity tests

# The suite runs in parallel pytest-xdist workers.  At torch's default of one
# intra-op thread per core their thread pools oversubscribe the cores, and
# the port's tests take several times as long, so each worker's OpenMP pool
# is cut to two threads.  Not through torch.set_num_threads: it also turns
# MKL's dynamic threading off, after which ResNet-18's train-mode gradients
# on the CPU came out up to 5e-2 off a float64 reference (torch 2.13).
threadpool_limits(2, user_api="openmp")


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


def _reference_humaniflow_state_dict(jparams, jm, scale=1.0):
    """A reference-format HumaniflowModel state dict from JAX params: the
    inverse of convert_humaniflow_checkpoint's name map (weights × scale)."""
    sd = {}

    def put(k, a):
        sd[k] = torch.from_numpy(np.ascontiguousarray(np.asarray(a) * scale, np.float32))

    enc_p, enc_s = jparams["encoder"]["params"], jparams["encoder"]["batch_stats"]

    def enc_name(mod):
        if "_block" not in mod:
            return mod
        layer, block = mod.split("_block")
        return f"{layer}.{block}"

    def walk(node_p, node_s, prefix):
        for name, child in node_p.items():
            if "kernel" in child:
                put(f"{prefix}{name.replace('downsample_conv', 'downsample.0')}.weight",
                    np.transpose(child["kernel"], (3, 2, 0, 1)))
            elif "scale" in child:
                ref = f"{prefix}{name.replace('downsample_bn', 'downsample.1')}"
                put(f"{ref}.weight", child["scale"])
                put(f"{ref}.bias", child["bias"])
                put(f"{ref}.running_mean", node_s[name]["mean"])
                put(f"{ref}.running_var", node_s[name]["var"])
                sd[f"{ref}.num_batches_tracked"] = torch.tensor(7)
            else:
                walk(child, node_s.get(name, {}), f"{prefix}{enc_name(name)}.")

    walk(enc_p, enc_s, "image_encoder.")
    for port, ref in (("fc1", "fc1"), ("fc_shape", "fc_shape"), ("fc_glob", "fc_glob"), ("fc_cam", "fc_cam"),
                      ("fc_isgc", "fc_input_shape_glob_cam_feats")):
        put(f"{ref}.weight", np.asarray(jparams[port]["kernel"]).T)
        put(f"{ref}.bias", jparams[port]["bias"])
    for part in range(jm.num_bodyparts):
        n_in = jm.isgc_dim + 9 * len(jm.ancestors[part])
        put(f"fc_flow_context.{part}.weight", np.asarray(jparams["fc_flow_context"]["kernel"][part, :n_in]).T)
        put(f"fc_flow_context.{part}.bias", jparams["fc_flow_context"]["bias"][part])
    slots = sorted((int(k.split("_")[1]), v) for k, v in jparams["flows"].items()
                   if "hypernet" in v or "log_gamma" in v)
    for m, (_, node) in enumerate(slots):
        if "log_gamma" in node:  # pyro's BatchNorm: gamma, whose relu(γ) + 1e-6 is exp(log_gamma)
            for part in range(jm.num_bodyparts):
                mod = f"pose_so3flow_transform_modules.{part * len(slots) + m}"
                put(f"{mod}.gamma", np.exp(node["log_gamma"][part]))
                put(f"{mod}.beta", node["beta"][part])
                put(f"{mod}.moving_mean", node["moving_mean"][part])
                put(f"{mod}.moving_variance", node["moving_var"][part])
            continue
        for layer, leaves in node["hypernet"].items():
            li = int(layer.split("_")[1])
            for part in range(jm.num_bodyparts):
                mod = f"pose_so3flow_transform_modules.{part * len(slots) + m}.nn.layers.{li}"
                put(f"{mod}.weight", np.asarray(leaves["kernel"][part]).T)
                put(f"{mod}.bias", leaves["bias"][part])
    return sd


class PerPartFlow:
    """A JAX ConditionalFlow applied part by part: parameters with a leading
    part axis, inputs with the part axis second to last (jax.vmap of the
    single flow).  The JAX model stacks its flow over the parts, which is
    right for the couplings and the conditional linear PLU but not for the
    masked transforms (`_apply_made` indexes the part axis with the block
    index), the unconditional linear PLU (its init converts a traced array
    under jax.vmap) or BatchNorm (its log-det is summed over the part axis
    too); with those the JAX model's flow is replaced by this."""

    def __init__(self, flow):
        self.flow = flow
        self.transforms = flow.transforms
        self.event_dim = flow.event_dim
        self.base_dist_std = flow.base_dist_std
        self.has_batch_norm = flow.has_batch_norm

    def forward(self, params, z, ctx):
        return jax.vmap(self.flow.forward, in_axes=(0, -2, -2), out_axes=-2)(params, z, ctx)

    def log_prob(self, params, y, ctx):
        return jax.vmap(self.flow.log_prob, in_axes=(0, -2, -2), out_axes=-1)(params, y, ctx)

    def update_batchnorm_stats(self, params, y, ctx):
        return jax.vmap(self.flow.update_batchnorm_stats, in_axes=(0, -2, -2))(params, y, ctx)


def menu_model_pair(transform_type, permute_type, batch_norm, num_j2d_samples=None, num_transforms=None,
                    num_spline_segments=None):
    """(JAX model, its params, port model holding them, port cfg, JAX cfg)
    at IMG² with the flow of the given factory variant, random encoder
    BatchNorm and random flow BatchNorm parameters.  Where the JAX model's
    stacked flow is not right, its flow is a PerPartFlow."""
    from humaniflow_torch.models import HumaniflowModel as TorchModel
    from humaniflow_torch.utils.convert_jax import params_from_jax
    from humaniflow_tpu.flows import transforms as jtransforms
    from humaniflow_tpu.models import HumaniflowModel as JaxModel

    jcfg, tcfg = small_cfgs(18)
    nf = dict(TRANSFORM_TYPE=transform_type, PERMUTE_TYPE=permute_type, BATCH_NORM=batch_norm)
    if num_transforms is not None:
        nf["NUM_TRANSFORMS"] = num_transforms
    if num_spline_segments is not None:
        nf["NUM_SPLINE_SEGMENTS"] = num_spline_segments
    for cfg in (jcfg, tcfg):
        cfg.MODEL = dataclasses.replace(cfg.MODEL, NORM_FLOW=dataclasses.replace(cfg.MODEL.NORM_FLOW, **nf))
        if num_j2d_samples is not None:
            cfg.LOSS = dataclasses.replace(cfg.LOSS, NUM_J2D_SAMPLES=num_j2d_samples)
    source = TorchModel(tcfg.MODEL, device="cpu", generator=torch.Generator().manual_seed(11))
    randomise_batchnorm(source)
    gen = torch.Generator().manual_seed(12)
    with torch.no_grad():
        for name, p in source.flow.named_parameters():
            if name.endswith(("log_gamma", "beta", "moving_mean")):
                p.uniform_(-0.3, 0.3, generator=gen)
            elif name.endswith("moving_var"):
                p.uniform_(0.5, 2.0, generator=gen)
    jm = JaxModel(jcfg.MODEL)
    init = jtransforms.LinearPLU.init
    if permute_type == "linear_plu":  # the shapes only: its init cannot run under jax.vmap
        jtransforms.LinearPLU.init = lambda self, key: {"LU": jnp.zeros((self.input_dim,) * 2)}
    try:
        jparams = jax_params_from_port(source, jm)
    finally:
        jtransforms.LinearPLU.init = init
    stacked_right = transform_type in ("spline_coupling", "additive_coupling", "affine_coupling")
    if not stacked_right or permute_type == "linear_plu" or batch_norm:
        jm.flow = PerPartFlow(jm.flow)
        jm.so3_dist = dataclasses.replace(jm.so3_dist, flow=jm.flow)
    tm = TorchModel(tcfg.MODEL, device="cpu", generator=torch.Generator().manual_seed(99))
    params_from_jax(jparams, tm)
    return jm, jparams, tm, tcfg, jcfg
