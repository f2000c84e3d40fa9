"""Carry weights across from the JAX package.

`params_from_jax` maps the JAX HumaniflowModel's parameter pytree (as nested
dicts of numpy arrays, e.g. `jax.tree_util.tree_map(np.asarray, params)`)
onto the port's HumaniflowModel:

* flax conv kernels HWIO → OIHW;
* BatchNorm scale/bias → weight/bias, batch_stats mean/var → running stats;
* dense kernels (in, out) → Linear weights (out, in);
* the 23-part stacked `fc_flow_context` and `flows` trees → the stacked
  (23, out, in) weights of the port: the coupling and linear-PLU hypernets,
  the MADE weights (23, blocks, out, in), the linear PLU's packed `LU`
  and the flow BatchNorm's `log_gamma`, `beta` and running statistics.

`hrnet_params_from_jax` does the same for the flax PoseHighResolutionNet's
variables ({'params', 'batch_stats'}) onto the port's PoseHighResolutionNet,
whose module paths are the flax ones joined with dots.

`smpl_from_numpy` (defined in models/smpl.py, re-exported here) does the
same for SMPL arrays, e.g. the fields of a JAX SMPLModel.
"""

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..models.hrnet import PoseHighResolutionNet
from ..models.humaniflow import HumaniflowModel
from ..models.smpl import smpl_from_numpy

__all__ = [
    "hrnet_params_from_jax", "hrnet_port_key", "jax_params_to_state_dict", "params_from_jax", "port_key",
    "smpl_from_numpy",
]

_ENCODER_LEAVES = {
    ("params", "kernel"): "weight",
    ("params", "scale"): "weight",
    ("params", "bias"): "bias",
    ("batch_stats", "mean"): "running_mean",
    ("batch_stats", "var"): "running_var",
}


def port_key(path: Tuple[str, ...], ndim: int) -> Tuple[str, Optional[Tuple[int, ...]]]:
    """(state_dict key, axis permutation from the JAX layout or None) of the
    JAX parameter at `path` with `ndim` dims."""
    top = path[0]
    if top == "encoder":
        # ('encoder', 'params'|'batch_stats', *modules, leaf)
        collection, *mods, leaf = path[1:]
        module = mods[0] if len(mods) == 1 else f"blocks.{mods[0]}.{mods[1]}"
        key = f"encoder.{module}.{_ENCODER_LEAVES[(collection, leaf)]}"
        return key, (3, 2, 0, 1) if ndim == 4 else None  # HWIO → OIHW
    kernel = path[-1] == "kernel"
    if top == "fc_flow_context":
        return ("fc_flow_context_weight", (0, 2, 1)) if kernel else ("fc_flow_context_bias", None)
    if top == "flows":
        i = int(path[1].split("_")[1])
        if len(path) == 3:  # ('flows', 'transform_i', 'LU' | a BatchNorm leaf)
            return f"flow.transforms.{i}.{path[2]}", None
        # ('flows', 'transform_i', 'hypernet'|'made', 'layer_k', 'kernel'|'bias')
        net, k = path[2], int(path[3].split("_")[1])
        kind = "weights" if kernel else "biases"
        perm = ((0, 2, 1) if net == "hypernet" else (0, 1, 3, 2)) if kernel else None
        return f"flow.transforms.{i}.{net}.{kind}.{k}", perm
    # fc1, fc_shape, fc_glob, fc_cam, fc_isgc
    return (f"{top}.weight", (1, 0)) if kernel else (f"{top}.bias", None)


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def jax_params_to_state_dict(np_params) -> Dict[str, torch.Tensor]:
    """The port's state_dict entries for a JAX parameter pytree."""
    state = {}
    for path, a in _flatten(np_params):
        key, perm = port_key(path, a.ndim)
        if perm is not None:
            a = a.transpose(perm)
        state[key] = torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))
    return state


def _load_checked(model, state):
    own = model.state_dict()
    missing = {k for k in own if not k.endswith("num_batches_tracked")} - set(state)
    unexpected = set(state) - set(own)
    if missing or unexpected:
        raise KeyError(f"missing {sorted(missing)}, unexpected {sorted(unexpected)}")
    for k, v in state.items():
        if tuple(own[k].shape) != tuple(v.shape):
            raise ValueError(f"{k}: JAX shape {tuple(v.shape)} vs port {tuple(own[k].shape)}")
    model.load_state_dict(state, strict=False)
    return model


def params_from_jax(np_params, model: HumaniflowModel) -> HumaniflowModel:
    """Load the JAX parameter pytree into `model` (in place; returns it).
    Raises if a tensor of either side has no counterpart or another shape."""
    return _load_checked(model, jax_params_to_state_dict(np_params))


def hrnet_port_key(path: Tuple[str, ...], ndim: int) -> Tuple[str, Optional[Tuple[int, ...]]]:
    """(state_dict key, axis permutation or None) of the flax HRNet variable
    at `path` = (collection, *modules, leaf)."""
    collection, *mods, leaf = path
    key = ".".join(mods) + "." + _ENCODER_LEAVES[(collection, leaf)]
    return key, (3, 2, 0, 1) if ndim == 4 else None  # HWIO → OIHW


def hrnet_params_from_jax(np_variables, hrnet: PoseHighResolutionNet) -> PoseHighResolutionNet:
    """Load flax PoseHighResolutionNet variables ({'params', 'batch_stats'},
    numpy leaves) into `hrnet` (in place; returns it).  Raises if a tensor
    of either side has no counterpart or another shape."""
    state = {}
    for path, a in _flatten(np_variables):
        key, perm = hrnet_port_key(path, a.ndim)
        if perm is not None:
            a = a.transpose(perm)
        state[key] = torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))
    return _load_checked(hrnet, state)
