"""Pose HRNet-W48 (eval mode) and its keypoint stage, plain.

Stem → 4 Bottlenecks → stages 2-4 of BASIC blocks over [48, 96, 192, 384]
channels with full cross-resolution fusion → 17 heatmaps at a quarter of
the input.  Weights are keyed as the network's checkpoint.  `dtype` is the
convolutions' arithmetic: "float32", "bf16" (inputs and weights cast, as the
configuration states), or "fp8", the control: e4m3 inputs and weights with
one scale a tensor, accumulated in bf16.  BatchNorm runs in float32.
"""

import torch
import torch.nn.functional as F

from .common import bn_eval
from .crop import crop_affine

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
FP8_MAX = 448.0


def _fp8(t):
    scale = t.abs().amax().float().clamp(min=1e-12) / FP8_MAX
    return ((t.float() / scale).to(torch.float8_e4m3fn).float() * scale).to(torch.bfloat16)


def _conv(w, name, x, dtype, stride=1, bias=False):
    weight = w[f"{name}.weight"]
    k = weight.shape[-1]
    b = w[f"{name}.bias"] if bias else None
    if dtype == "float32":
        return F.conv2d(x.float(), weight, b, stride, k // 2)
    if dtype == "bf16":
        x, weight = x.to(torch.bfloat16), weight.to(torch.bfloat16)
    else:
        x, weight = _fp8(x), _fp8(weight)
    return F.conv2d(x, weight, None if b is None else b.to(torch.bfloat16), stride, k // 2)


def _bn(w, name, x):
    return bn_eval(x.float(), w, name)


def _basic(w, p, x, dtype):
    y = F.relu(_bn(w, f"{p}.bn1", _conv(w, f"{p}.conv1", x, dtype)))
    y = _bn(w, f"{p}.bn2", _conv(w, f"{p}.conv2", y, dtype))
    return F.relu(y + x)


def _bottleneck(w, p, x, dtype):
    y = F.relu(_bn(w, f"{p}.bn1", _conv(w, f"{p}.conv1", x, dtype)))
    y = F.relu(_bn(w, f"{p}.bn2", _conv(w, f"{p}.conv2", y, dtype)))
    y = _bn(w, f"{p}.bn3", _conv(w, f"{p}.conv3", y, dtype))
    if f"{p}.downsample_conv.weight" in w:
        x = _bn(w, f"{p}.downsample_bn", _conv(w, f"{p}.downsample_conv", x, dtype))
    return F.relu(y + x)


def _module(w, p, xs, num_out, dtype, blocks):
    ys = []
    for b, y in enumerate(xs):
        for k in range(blocks):
            y = _basic(w, f"{p}.branch{b}_block{k}", y, dtype)
        ys.append(y)
    fused = []
    for i in range(num_out):
        acc = None
        for j, y in enumerate(ys):
            if j > i:
                v = _bn(w, f"{p}.fuse{i}_{j}_bn", _conv(w, f"{p}.fuse{i}_{j}_conv", y, dtype))
                f = 2 ** (j - i)
                v = v.repeat_interleave(f, dim=2).repeat_interleave(f, dim=3)
            elif j < i:
                v = y
                for k in range(i - j):
                    v = _bn(w, f"{p}.fuse{i}_{j}_bn{k}", _conv(w, f"{p}.fuse{i}_{j}_conv{k}", v, dtype, stride=2))
                    if k != i - j - 1:
                        v = F.relu(v)
            else:
                v = y
            acc = v if acc is None else acc + v
        fused.append(F.relu(acc))
    return fused


def heatmaps(w, hrnet_cfg, x, dtype):
    """(B, H, W, 3) NHWC normalised crops → (B, H/4, W/4, K) float32 heatmaps."""
    modules, blocks = hrnet_cfg["STAGE_MODULES"], hrnet_cfg["STAGE_BLOCKS"]
    x = x.permute(0, 3, 1, 2)
    x = F.relu(_bn(w, "bn1", _conv(w, "conv1", x, dtype, stride=2)))
    x = F.relu(_bn(w, "bn2", _conv(w, "conv2", x, dtype, stride=2)))
    for k in range(4):
        x = _bottleneck(w, f"layer1_block{k}", x, dtype)
    xs = [F.relu(_bn(w, "transition1_0_bn", _conv(w, "transition1_0_conv", x, dtype))),
          F.relu(_bn(w, "transition1_1_bn", _conv(w, "transition1_1_conv", x, dtype, stride=2)))]
    for s, n_modules in zip((2, 3, 4), modules):
        if s > 2:
            t = f"transition{s - 1}_{s - 1}"
            xs = xs + [F.relu(_bn(w, f"{t}_bn", _conv(w, f"{t}_conv", xs[-1], dtype, stride=2)))]
        for m in range(n_modules):
            num_out = 1 if (s == 4 and m == n_modules - 1) else s
            xs = _module(w, f"stage{s}_module{m}", xs, num_out, dtype, blocks)
    return _conv(w, "final_layer", xs[0], dtype, bias=True).float().permute(0, 2, 3, 1)


def keypoint_stage(w, hrnet_cfg, images_by_size, boxes, dtype):
    """HRNet on person crops.  images_by_size: [(indices, (n, H, W, 3) in
    [0, 1])]; boxes: (centres (N, 2) as (y, x), heights (N,), widths (N,)).
    Returns the input crops (N, in_h, in_w, 3) and the heatmaps (N, h, w, K)."""
    in_w, in_h = hrnet_cfg["INPUT_WH"]
    centres, heights, widths = boxes
    n = sum(len(i) for i, _ in images_by_size)
    crops = torch.empty((n, in_h, in_w, 3), device=centres.device)
    for idxs, rgb in images_by_size:
        idx = torch.tensor(idxs, device=centres.device)
        crops[idx] = crop_affine((in_w, in_h), rgb, centres[idx], heights[idx], widths[idx],
                                 hrnet_cfg["BBOX_SCALE_FACTOR"])[0]
    mean = torch.tensor(IMAGENET_MEAN, device=crops.device)
    std = torch.tensor(IMAGENET_STD, device=crops.device)
    return crops, heatmaps(w, hrnet_cfg, (crops - mean) / std, dtype)
