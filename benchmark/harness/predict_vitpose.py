"""The uncropped prediction with ViTPose in HRNet's place, and how it is
judged.

`PredictUncroppedViTPose` is `PredictUncropped` with the keypoint net
swapped: the program's `predict_hrnet_batch` runs the configuration's
`VITPOSE` net (ViTPose-H at 256×192 in bf16) on B photos with their person
boxes, then the square 256² crop of each 256×192 crop, then
`predict_humaniflow`.  The reference is `reference/vitpose.py` in the same
place; its heatmaps judge the program's argmax keypoints and confidences
(`vitpose`, by `hrnet_gap`'s rule), and the crops and the prediction that
follow take the judged side's keypoints, as in `PredictUncropped`.

The seeded weights (`vitpose_spec`) follow ViTPose's published
initialisation where a fault stays visible: linear weights N(0, 0.02²),
unit LayerNorm, the patch embedding U(±1/√fan_in).  Where the published
recipe is zero, the identity or small, a planted fault could not show or
only barely: the linear biases are N(0, BIAS_STD²) and the position
embedding N(0, POS_EMBED_STD²), both 0.1 (published 0 and 0.02, at which a
dropped qkv bias or a missing row-0 term read 0.027, under the `vitpose`
limit of 0.03), and the head's BatchNorm is randomised as HuManiFlow's
is.  The head's deconvolutions are LeCun-normal × DECONV_GAIN and its last
convolution LeCun-normal × FINAL_GAIN with bias FINAL_BIAS, so that the
heatmaps have structure and about half the keypoints clear the proxy's 0.75
visibility threshold (the published head init, N(0, 0.001²), gives
heatmaps of order 1e-3).
"""

import importlib

import torch

from ..reference import crop as ref_crop
from ..reference import humaniflow as ref_hf
from ..reference import vitpose as ref_vitpose
from ..reference.common import precision as ref_precision
from . import inputs
from .predict import Predict, PredictUncropped, _max_abs, decode, hrnet_gap, prediction_numbers, worst


def vitpose_spec(cfg: dict) -> list:
    """(key, shape, init) of every tensor of the mmpose ViTPose checkpoint at
    the configuration's widths (the module docstring's recipe)."""
    d, p, depth = cfg["EMBED_DIM"], cfg["PATCH_SIZE"], cfg["DEPTH"]
    hidden = int(d * cfg["MLP_RATIO"])
    in_w, in_h = cfg["INPUT_WH"]
    std, bias_std = cfg["LINEAR_STD"], cfg["BIAS_STD"]
    bound = 1.0 / (3 * p * p) ** 0.5
    spec = [("backbone.patch_embed.proj.weight", (d, 3, p, p), ("uniform", -bound, bound)),
            ("backbone.patch_embed.proj.bias", (d,), ("uniform", -bound, bound)),
            ("backbone.pos_embed", (1, (in_h // p) * (in_w // p) + 1, d), ("normal", cfg["POS_EMBED_STD"]))]

    def norm(name, c):
        spec.extend([(f"{name}.weight", (c,), ("const", 1.0)), (f"{name}.bias", (c,), ("const", 0.0))])

    def linear(name, out_f, in_f, bias=True):
        spec.append((f"{name}.weight", (out_f, in_f), ("normal", std)))
        if bias:
            spec.append((f"{name}.bias", (out_f,), ("normal", bias_std)))

    for i in range(depth):
        b = f"backbone.blocks.{i}"
        norm(f"{b}.norm1", d)
        linear(f"{b}.attn.qkv", 3 * d, d, cfg["QKV_BIAS"])
        linear(f"{b}.attn.proj", d, d)
        norm(f"{b}.norm2", d)
        linear(f"{b}.mlp.fc1", hidden, d)
        linear(f"{b}.mlp.fc2", d, hidden)
    norm("backbone.last_norm", d)
    in_ch = d
    for j, f in enumerate(cfg["DECONV_FILTERS"]):
        # a k=4, s=2 transposed convolution: each output sums 4 taps of every input channel
        spec.append((f"keypoint_head.deconv_layers.{3 * j}.weight", (in_ch, f, 4, 4),
                     ("normal", cfg["DECONV_GAIN"] / (4 * in_ch) ** 0.5)))
        inputs._bn(spec, f"keypoint_head.deconv_layers.{3 * j + 1}", f, True)
        in_ch = f
    k = cfg["NUM_JOINTS"]
    spec += [("keypoint_head.final_layer.weight", (k, in_ch, 1, 1), ("normal", cfg["FINAL_GAIN"] / in_ch ** 0.5)),
             ("keypoint_head.final_layer.bias", (k,), ("const", cfg["FINAL_BIAS"]))]
    return spec


def vitpose_net(cfg: dict, device):
    """The program's ViTPose at the configuration's widths and dtype."""
    from humaniflow_torch.models import vitpose

    net = vitpose.ViTPose(
        embed_dim=cfg["EMBED_DIM"], depth=cfg["DEPTH"], num_heads=cfg["NUM_HEADS"], mlp_ratio=cfg["MLP_RATIO"],
        qkv_bias=cfg["QKV_BIAS"], img_size=tuple(cfg["INPUT_WH"][::-1]), patch_size=cfg["PATCH_SIZE"],
        patch_padding=cfg["PATCH_PADDING"], deconv_filters=tuple(cfg["DECONV_FILTERS"]), num_joints=cfg["NUM_JOINTS"],
        dtype={"bf16": torch.bfloat16, "float32": None}[cfg["DTYPE"]], device=device)
    if cfg["LN_EPS"] != vitpose.LN_EPS or list(net.heatmap_wh) != list(cfg["HEATMAP_WH"]):
        raise ValueError(f"the program's ViTPose has LayerNorm eps {vitpose.LN_EPS} and heatmaps {net.heatmap_wh}")
    return net


class PredictUncroppedViTPose(PredictUncropped):
    """`PredictUncropped` with the configuration's ViTPose as the keypoint
    net (`VITPOSE`, no `HRNET`)."""

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        Predict.__init__(self, config, traffic, seed, device)
        vp = config["VITPOSE"]
        g = torch.Generator(self.device).manual_seed(seed + 1)
        self.vitpose_weights = inputs.draw_weights(vitpose_spec(vp), g, self.device)
        self.vitpose = vitpose_net(vp, self.device)
        self.vitpose.load_state_dict(self.vitpose_weights, assign=True)  # one copy of the weights on the device

    def _hrnet_then_crop(self, x, span):
        ph = importlib.import_module("humaniflow_torch.pipelines.predict_hrnet")
        from humaniflow_torch.data.image_ops import batch_crop_affine

        with span("vitpose_stage_ms"):
            kp = ph.predict_hrnet_batch(self.vitpose, x["photos"], bboxes=x["boxes"], device=self.device)
        in_w, in_h = self.config["VITPOSE"]["INPUT_WH"]
        side, n, wh = float(max(in_w, in_h)), self.b, self.config["DATA"]["PROXY_REP_SIZE"]
        crop = batch_crop_affine(
            (wh, wh), rgb=kp["cropped_images"], joints2d=kp["joints2D"],
            bbox_centres=torch.tensor([in_h / 2.0, in_w / 2.0], device=self.device).expand(n, 2),
            bbox_heights=torch.full((n,), side, device=self.device),
            bbox_widths=torch.full((n,), side, device=self.device), orig_scale_factor=1.0)
        return kp, crop

    def free(self):
        Predict.free(self)
        del self.vitpose

    def reference(self, kept, precision: str, judged=None) -> dict:
        """As `PredictUncropped.reference`, with the reference's ViTPose: its
        heatmaps judge the program's argmax keypoints and confidences
        (`vitpose`); the crops and the prediction take `judged`'s keypoints,
        or, for the control (fp8 products in the program's place), its own."""
        p, _ = kept
        x, vp = self.pool[p], self.config["VITPOSE"]
        dev = self.device
        boxes = (torch.tensor([b[0] for b in x["boxes"]], device=dev),
                 torch.tensor([b[1] for b in x["boxes"]], device=dev, dtype=torch.float32),
                 torch.tensor([b[2] for b in x["boxes"]], device=dev, dtype=torch.float32))
        by_size = {}
        for k, img in enumerate(x["photos"]):
            by_size.setdefault(img.shape, []).append(k)
        groups = [(idx, torch.stack([torch.as_tensor(x["photos"][k], device=dev) for k in idx]))
                  for idx in by_size.values()]
        dtype = vp["DTYPE"] if precision == "float32" else "fp8"
        with torch.no_grad(), ref_precision(precision):
            crops, heat = ref_vitpose.keypoint_stage(self.vitpose_weights, vp, groups, boxes, dtype)
            if judged is None:
                kp, conf = decode(heat, vp)
            else:
                kp, conf = judged["joints2D"], judged["joints2Dconfs"]
            in_w, in_h = vp["INPUT_WH"]
            n, wh, side = self.b, self.config["DATA"]["PROXY_REP_SIZE"], float(max(in_w, in_h))
            rgb, j2d, _, _ = ref_crop.crop_affine(
                (wh, wh), crops, torch.tensor([in_h / 2.0, in_w / 2.0], device=dev).expand(n, 2),
                torch.full((n,), side, device=dev), torch.full((n,), side, device=dev), 1.0, joints2d=kp)
            out = ref_hf.predict(self.weights, self.smpl_ref, self.config, rgb, j2d, conf, x["noise"])
        out.update(cropped_images=crops, crop_rgb=rgb, heatmaps=heat, joints2D=kp, joints2Dconfs=conf)
        return out

    def numbers(self, got: dict, want: dict) -> dict:
        return {"vitpose": hrnet_gap(got, want, self.config["VITPOSE"]),
                "crops": worst([_max_abs(got["cropped_images"], want["cropped_images"]),
                                _max_abs(got["crop_rgb"], want["crop_rgb"])]),
                **prediction_numbers(got, want)}
