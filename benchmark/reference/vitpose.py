"""ViTPose (eval mode) and its keypoint stage, plain.

Xu et al., NeurIPS 2022, ViTPose-H at 256×192 (mmpose's
`ViTPose_huge_coco_256x192.py`, `backbones/vit.py`,
`TopdownHeatmapSimpleHead`): the patch embedding (a 16×16 convolution of
stride 16 and padding 2), the position embedding with its row 0 added to
every token, pre-LN blocks (multi-head attention with qkv bias and scale
head_dim^-1/2, an MLP with exact GELU; LayerNorm eps 1e-6), last_norm, two
deconvolutions (k 4, s 2, p 1, no bias) each with BatchNorm and ReLU, and a
1×1 convolution to the heatmaps at a quarter of the crop.  Every product is
written out: the linears as matrix products, attention as QKᵀ, an explicit
softmax and PV.  Weights are keyed as mmpose's checkpoint.

`dtype` is the products' arithmetic: "float32"; "bf16" (inputs and weights
cast to bf16, accumulated in float32, each product rounded once to bf16, as
the configuration states; QKᵀ of the bf16 q and k in float32, the
probabilities rounded to bf16 before PV); or "fp8", the control: e4m3
inputs and weights with one scale a tensor, accumulated in bf16.  The
residual stream, LayerNorm, the softmax, BatchNorm and the heatmaps run in
float32.

Departures from the published code: no flip test and no UDP post-processing
(mmpose's evaluation settings; HuManiFlow's stage decodes one pass by
argmax); drop-path (0.55, training only) left out.
"""

import math

import torch
import torch.nn.functional as F

from .common import bn_eval
from .crop import crop_affine
from .hrnet import IMAGENET_MEAN, IMAGENET_STD, _fp8


def _operands(dtype, *ts):
    if dtype == "float32":
        return [t.float() for t in ts]
    if dtype == "bf16":
        return [t.to(torch.bfloat16) for t in ts]
    return [_fp8(t) for t in ts]


def _linear(w, name, x, dtype):
    """x (..., in) @ weightᵀ + bias, rounded once to the products' dtype."""
    a, b = _operands(dtype, x.reshape(-1, x.shape[-1]), w[f"{name}.weight"])
    bias = w[f"{name}.bias"].to(a.dtype)
    return torch.addmm(bias, a, b.t()).reshape(*x.shape[:-1], b.shape[0])


def _layer_norm(w, name, x, eps):
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * w[f"{name}.weight"] + w[f"{name}.bias"]


def _attention(w, p, x, heads, dtype):
    b, t, d = x.shape
    qkv = _linear(w, f"{p}.qkv", x, dtype).reshape(b, t, 3, heads, d // heads).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]
    qf, kf = (u.float() for u in _operands(dtype, q, k))
    s = torch.matmul(qf, kf.transpose(-2, -1)) * (d // heads) ** -0.5
    e = torch.exp(s - s.amax(-1, keepdim=True))
    prob = e / e.sum(-1, keepdim=True)
    pv = torch.matmul(*_operands(dtype, prob, v))
    return _linear(w, f"{p}.proj", pv.transpose(1, 2).reshape(b, t, d), dtype)


def _mlp(w, p, x, dtype):
    h = _linear(w, f"{p}.fc1", x, dtype).float()
    h = 0.5 * h * (1.0 + torch.erf(h / math.sqrt(2.0)))
    return _linear(w, f"{p}.fc2", h, dtype)


def _conv(w, name, x, dtype, stride, padding, transposed=False):
    a, k = _operands(dtype, x, w[f"{name}.weight"])
    bias = w.get(f"{name}.bias")
    bias = None if bias is None else bias.to(a.dtype)
    if transposed:
        return F.conv_transpose2d(a, k, bias, stride, padding)
    return F.conv2d(a, k, bias, stride, padding)


def heatmaps(w, cfg, x, dtype):
    """(B, H, W, 3) NHWC normalised crops → (B, H/4, W/4, K) float32 heatmaps."""
    eps, heads = cfg["LN_EPS"], cfg["NUM_HEADS"]
    x = _conv(w, "backbone.patch_embed.proj", x.permute(0, 3, 1, 2), dtype, cfg["PATCH_SIZE"], cfg["PATCH_PADDING"])
    b, d, hp, wp = x.shape
    pos = w["backbone.pos_embed"]
    x = x.flatten(2).transpose(1, 2).float() + pos[:, 1:] + pos[:, :1]
    for i in range(cfg["DEPTH"]):
        p = f"backbone.blocks.{i}"
        x = x + _attention(w, f"{p}.attn", _layer_norm(w, f"{p}.norm1", x, eps), heads, dtype).float()
        x = x + _mlp(w, f"{p}.mlp", _layer_norm(w, f"{p}.norm2", x, eps), dtype).float()
    x = _layer_norm(w, "backbone.last_norm", x, eps).transpose(1, 2).reshape(b, d, hp, wp)
    for j in range(len(cfg["DECONV_FILTERS"])):
        x = _conv(w, f"keypoint_head.deconv_layers.{3 * j}", x, dtype, 2, 1, transposed=True)
        x = F.relu(bn_eval(x.float(), w, f"keypoint_head.deconv_layers.{3 * j + 1}"))
    return _conv(w, "keypoint_head.final_layer", x, dtype, 1, 0).float().permute(0, 2, 3, 1)


def keypoint_stage(w, cfg, images_by_size, boxes, dtype):
    """ViTPose on person crops.  images_by_size: [(indices, (n, H, W, 3) in
    [0, 1])]; boxes: (centres (N, 2) as (y, x), heights (N,), widths (N,)).
    Returns the input crops (N, in_h, in_w, 3) and the heatmaps (N, h, w, K)."""
    in_w, in_h = cfg["INPUT_WH"]
    centres, heights, widths = boxes
    n = sum(len(i) for i, _ in images_by_size)
    crops = torch.empty((n, in_h, in_w, 3), device=centres.device)
    for idxs, rgb in images_by_size:
        idx = torch.tensor(idxs, device=centres.device)
        crops[idx] = crop_affine((in_w, in_h), rgb, centres[idx], heights[idx], widths[idx],
                                 cfg["BBOX_SCALE_FACTOR"])[0]
    mean = torch.tensor(IMAGENET_MEAN, device=crops.device)
    std = torch.tensor(IMAGENET_STD, device=crops.device)
    return crops, heatmaps(w, cfg, (crops - mean) / std, dtype)
