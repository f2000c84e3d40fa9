"""Load the reference implementation's released checkpoints into the port.

The PyTorch counterpart of `humaniflow_tpu/utils/convert_torch.py`: the
reference's HuManiFlow `.tar` (`humaniflow_weights.tar`) and HRNet-W48 `.pth`
(`pose_hrnet_w48_384x288.pth`) name their tensors after the reference's
module tree; these loaders map those names onto the port's parameters.  Both
sides are PyTorch, so convolution and linear weights keep their layouts;
what changes is the naming and, for the HuManiFlow model, the stacking:

* the torchvision-style encoder `image_encoder.layerX.Y.*` → `encoder.blocks.
  layerX_blockY.*`, `downsample.0/1` → `downsample_conv` / `downsample_bn`;
* `fc_input_shape_glob_cam_feats` → `fc_isgc`;
* the 23 per-part context layers `fc_flow_context.{part}` (256 + 9·ancestors
  inputs) → rows of the stacked (23, 64, 256 + 9·max_ancestors) weight, the
  inputs of absent ancestor slots zero;
* the per-part flow modules `pose_so3flow_transform_modules.{part·M + m}`
  (M modules a part: every hypernet, of a coupling or of the conditional
  linear PLU, and pyro's BatchNorm layers) → row `part` of the m-th
  module's stacked weights: `nn.layers.{l}` for a hypernet; `gamma`,
  `beta`, `moving_mean` and `moving_variance` for a BatchNorm layer, with
  log_gamma = log(relu(γ) + 1e-6).  The masked transforms and the
  unconditional linear PLU have no mapping, as in the JAX converter.

`load_humaniflow_checkpoint` also takes the port's own training
checkpoints (`pipelines/train.py` through `utils/checkpoints.py`), which
need no mapping.  Both loaders are strict: a tensor the port needs that the
file lacks, or a tensor in the file that the map does not use (BatchNorm's
`num_batches_tracked` aside), raises KeyError; a shape mismatch raises
ValueError.  Checkpoints are pickles: load only files you trust.
"""

import re
from typing import Dict

import torch

from ..flows.autoregressive import FlowBatchNorm
from ..models.hrnet import PoseHighResolutionNet
from ..models.humaniflow import HumaniflowModel


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """The state dict of a reference checkpoint on the CPU: a `.tar` training
    checkpoint's `best_model_state_dict`, else its `model_state_dict`, else
    the file itself as a raw state dict (`.pth`)."""
    return _reference_state_dict(torch.load(path, map_location="cpu", weights_only=False))


def _reference_state_dict(blob) -> Dict[str, torch.Tensor]:
    """load_torch_state_dict of an already loaded file."""
    if isinstance(blob, dict) and "best_model_state_dict" in blob:
        sd = blob["best_model_state_dict"]
    elif isinstance(blob, dict) and "model_state_dict" in blob:
        sd = blob["model_state_dict"]
    else:
        sd = blob
    return {k: v.detach().cpu() for k, v in sd.items()}


class _Reader:
    """Reads reference tensors by name and remembers which it used."""

    def __init__(self, sd: Dict[str, torch.Tensor]):
        self.sd = sd
        self.used = set()

    def __call__(self, name: str) -> torch.Tensor:
        if name not in self.sd:
            raise KeyError(f"the checkpoint has no tensor {name!r}")
        self.used.add(name)
        return self.sd[name].to(torch.float32)

    def check_all_used(self):
        extra = sorted(k for k in set(self.sd) - self.used if not k.endswith("num_batches_tracked"))
        if extra:
            raise KeyError(f"the checkpoint has tensors the port does not use: {extra[:10]}"
                           + (f" and {len(extra) - 10} more" if len(extra) > 10 else ""))


def _load_state(module: torch.nn.Module, state: Dict[str, torch.Tensor]):
    """Copy `state` into `module`: every tensor of the module except
    BatchNorm's num_batches_tracked must be given, with its shape, and no
    other."""
    own = module.state_dict()
    missing = sorted(k for k in own if not k.endswith("num_batches_tracked") and k not in state)
    if missing:
        raise KeyError(f"no checkpoint tensor maps onto {missing[:10]}")
    extra = sorted(k for k in state if k not in own)
    if extra:
        raise KeyError(f"the checkpoint has tensors the port does not use: {extra[:10]}")
    for k, v in state.items():
        if tuple(own[k].shape) != tuple(v.shape):
            raise ValueError(f"{k}: checkpoint shape {tuple(v.shape)} vs port {tuple(own[k].shape)}")
    module.load_state_dict(state, strict=False)


def _encoder_reference_name(port_key: str) -> str:
    """encoder.* state key of the port → the reference's image_encoder.* name."""
    name = port_key[len("encoder."):]
    m = re.fullmatch(r"blocks\.layer(\d+)_block(\d+)\.(.+)", name)
    if m:
        rest = m.group(3).replace("downsample_conv", "downsample.0").replace("downsample_bn", "downsample.1")
        name = f"layer{m.group(1)}.{m.group(2)}.{rest}"
    return f"image_encoder.{name}"


def humaniflow_state_from_reference(sd: Dict[str, torch.Tensor], model: HumaniflowModel) -> Dict[str, torch.Tensor]:
    """The port's state dict for a reference HumaniflowModel state dict."""
    read = _Reader(sd)
    state = {}
    for key in model.state_dict():
        if key.startswith("encoder.") and not key.endswith("num_batches_tracked"):
            state[key] = read(_encoder_reference_name(key))
    for port, ref in (("fc1", "fc1"), ("fc_shape", "fc_shape"), ("fc_glob", "fc_glob"), ("fc_cam", "fc_cam"),
                      ("fc_isgc", "fc_input_shape_glob_cam_feats")):
        state[f"{port}.weight"] = read(f"{ref}.weight")
        state[f"{port}.bias"] = read(f"{ref}.bias")

    w = torch.zeros_like(model.fc_flow_context_weight, device="cpu")
    b = torch.zeros_like(model.fc_flow_context_bias, device="cpu")
    isgc = model.isgc_dim
    for part in range(model.num_bodyparts):
        n_in = isgc + 9 * len(model.ancestors[part])
        wp = read(f"fc_flow_context.{part}.weight")
        if tuple(wp.shape) != (w.shape[1], n_in):
            raise ValueError(f"fc_flow_context.{part}.weight has shape {tuple(wp.shape)}, expected "
                             f"{(w.shape[1], n_in)}")
        w[part, :, :n_in] = wp
        b[part] = read(f"fc_flow_context.{part}.bias")
    state["fc_flow_context_weight"] = w
    state["fc_flow_context_bias"] = b

    # the reference's per-part module list holds the modules with weights:
    # every hypernet and, with BATCH_NORM, pyro's BatchNorm layers
    slots = [i for i, t in enumerate(model.flow.transforms) if hasattr(t, "hypernet") or isinstance(t, FlowBatchNorm)]
    for m, slot in enumerate(slots):
        t = model.flow.transforms[slot]

        def ref_name(part, leaf):
            return f"pose_so3flow_transform_modules.{part * len(slots) + m}.{leaf}"

        def stacked(leaf):
            return torch.stack([read(ref_name(part, leaf)) for part in range(model.num_bodyparts)])

        if isinstance(t, FlowBatchNorm):
            # pyro's positive γ̂ = relu(γ) + 1e-6 is the port's exp(log_gamma)
            prefix = f"flow.transforms.{slot}"
            state[f"{prefix}.log_gamma"] = torch.log(torch.relu(stacked("gamma")) + 1e-6)
            state[f"{prefix}.beta"] = stacked("beta")
            state[f"{prefix}.moving_mean"] = stacked("moving_mean")
            state[f"{prefix}.moving_var"] = stacked("moving_variance")
            continue
        for kind, ref_leaf in (("weights", "weight"), ("biases", "bias")):
            for layer in range(len(getattr(t.hypernet, kind))):
                state[f"flow.transforms.{slot}.hypernet.{kind}.{layer}"] = stacked(f"nn.layers.{layer}.{ref_leaf}")
    read.check_all_used()
    return state


def load_humaniflow_checkpoint(path: str, model: HumaniflowModel) -> HumaniflowModel:
    """Load a HuManiFlow checkpoint into `model`, in place; returns it.

    A checkpoint of the port's own `train_humaniflow` (utils/checkpoints.py,
    recognised by its `best_params` or `params` key) gives its `best_params`,
    else its `params`, already in the port's names, as the JAX CLIs take
    their own checkpoints.  Any other file is the reference's `.tar` (or a
    state-dict file), whose names are mapped onto the port's."""
    blob = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(blob, dict) and ("best_params" in blob or "params" in blob):
        state = blob.get("best_params", blob.get("params"))
        _load_state(model, {k: v.detach().cpu() for k, v in state.items()})
    else:
        _load_state(model, humaniflow_state_from_reference(_reference_state_dict(blob), model))
    return model


def _hrnet_reference_name(port_module: str) -> str:
    """Module path of the port's HRNet → the reference's module path."""
    rules = (
        (r"layer1_block(\d+)\.downsample_conv", r"layer1.\1.downsample.0"),
        (r"layer1_block(\d+)\.downsample_bn", r"layer1.\1.downsample.1"),
        (r"layer1_block(\d+)\.(conv\d|bn\d)", r"layer1.\1.\2"),
        (r"transition1_0_conv", "transition1.0.0"),
        (r"transition1_0_bn", "transition1.0.1"),
        (r"transition(\d)_(\d)_conv", r"transition\1.\2.0.0"),
        (r"transition(\d)_(\d)_bn", r"transition\1.\2.0.1"),
        (r"stage(\d)_module(\d+)\.branch(\d)_block(\d)\.(conv\d|bn\d)", r"stage\1.\2.branches.\3.\4.\5"),
        (r"stage(\d)_module(\d+)\.fuse(\d)_(\d)_conv", r"stage\1.\2.fuse_layers.\3.\4.0"),
        (r"stage(\d)_module(\d+)\.fuse(\d)_(\d)_bn", r"stage\1.\2.fuse_layers.\3.\4.1"),
        (r"stage(\d)_module(\d+)\.fuse(\d)_(\d)_conv(\d)", r"stage\1.\2.fuse_layers.\3.\4.\5.0"),
        (r"stage(\d)_module(\d+)\.fuse(\d)_(\d)_bn(\d)", r"stage\1.\2.fuse_layers.\3.\4.\5.1"),
        (r"(conv1|bn1|conv2|bn2|final_layer)", r"\1"),
    )
    for pattern, repl in rules:
        if re.fullmatch(pattern, port_module):
            return re.sub(pattern, repl, port_module)
    raise KeyError(f"no reference name for the HRNet module {port_module!r}")


def hrnet_state_from_reference(sd: Dict[str, torch.Tensor], hrnet: PoseHighResolutionNet) -> Dict[str, torch.Tensor]:
    """The port's HRNet state dict for a reference pose_hrnet_w48 state dict."""
    read = _Reader(sd)
    state = {}
    for key in hrnet.state_dict():
        if key.endswith("num_batches_tracked"):
            continue
        module, leaf = key.rsplit(".", 1)
        state[key] = read(f"{_hrnet_reference_name(module)}.{leaf}")
    read.check_all_used()
    return state


def load_hrnet_checkpoint(path: str, hrnet: PoseHighResolutionNet) -> PoseHighResolutionNet:
    """Load the reference's HRNet-W48 `.pth` into `hrnet`, in place; returns it."""
    _load_state(hrnet, hrnet_state_from_reference(load_torch_state_dict(path), hrnet))
    return hrnet
