"""Carry weights across from the JAX package.

`params_from_jax` maps the JAX HumaniflowModel's parameter pytree (as nested
dicts of numpy arrays, e.g. `jax.tree_util.tree_map(np.asarray, params)`)
onto the port's HumaniflowModel:

* flax conv kernels HWIO → OIHW;
* BatchNorm scale/bias → weight/bias, batch_stats mean/var → running stats;
* dense kernels (in, out) → Linear weights (out, in);
* the 23-part stacked `fc_flow_context` and `flows` trees → the stacked
  (23, out, in) weights of the port.

`smpl_from_numpy` (defined in models/smpl.py, re-exported here) does the
same for SMPL arrays, e.g. the fields of a JAX SMPLModel.
"""

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..models.humaniflow import HumaniflowModel
from ..models.smpl import smpl_from_numpy

__all__ = ["jax_params_to_state_dict", "params_from_jax", "port_key", "smpl_from_numpy"]

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
        # ('flows', 'transform_i', 'hypernet', 'layer_k', 'kernel'|'bias')
        i = int(path[1].split("_")[1])
        k = int(path[3].split("_")[1])
        kind = "weights" if kernel else "biases"
        return f"flow.transforms.{i}.hypernet.{kind}.{k}", (0, 2, 1) if kernel else None
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


def params_from_jax(np_params, model: HumaniflowModel) -> HumaniflowModel:
    """Load the JAX parameter pytree into `model` (in place; returns it).
    Raises if a tensor of either side has no counterpart or another shape."""
    state = jax_params_to_state_dict(np_params)
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
