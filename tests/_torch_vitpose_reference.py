"""ViTPose's forward, plain, for the port's CPU tests (the benchmark keeps
its own copy in benchmark/reference/vitpose.py).

Plain PyTorch, importing nothing of the port: the patch embedding (a p×p
convolution of stride p and the given padding), the position embedding with
row 0 added to every token, pre-LN blocks with every product written out
(the linears as x·Wᵀ + b, attention as QKᵀ·head_dim^-1/2, an explicit
softmax, then PV), exact GELU, LayerNorm as its formula (eps 1e-6),
last_norm, the deconvolution head (k 4, s 2, p 1, no bias; BatchNorm on its
running statistics, eps 1e-5; ReLU) and the 1×1 convolution.  Weights are
keyed as mmpose's checkpoint (`backbone.*`, `keypoint_head.*`).

`dtype` "float32", or "bf16": each product's inputs and weights in bf16,
accumulated in float32 and rounded once to bf16; QKᵀ of the bf16 q and k in
float32 and the probabilities rounded to bf16 before PV; the residual
stream, LayerNorm, the softmax statistics and BatchNorm in float32.

Departures from the published code: no flip test and no UDP (mmpose's
evaluation settings, not HuManiFlow's stage); drop-path (training only)
left out.
"""

import math

import torch
import torch.nn.functional as F

LN_EPS = 1e-6
BN_EPS = 1e-5


def _cast(dtype, *ts):
    target = torch.float32 if dtype == "float32" else torch.bfloat16
    return [t.to(target) for t in ts]


def linear(w, name, x, dtype):
    x2, weight, bias = _cast(dtype, x.reshape(-1, x.shape[-1]), w[f"{name}.weight"], w[f"{name}.bias"])
    return torch.addmm(bias, x2, weight.t()).reshape(*x.shape[:-1], weight.shape[0])


def layer_norm(w, name, x):
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + LN_EPS) * w[f"{name}.weight"] + w[f"{name}.bias"]


def attention(w, p, x, num_heads, dtype):
    b, t, d = x.shape
    hd = d // num_heads
    qkv = linear(w, f"{p}.qkv", x, dtype).reshape(b, t, 3, num_heads, hd).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0].float(), qkv[1].float(), qkv[2]
    scores = torch.matmul(q, k.transpose(-2, -1)) * hd ** -0.5
    e = torch.exp(scores - scores.amax(-1, keepdim=True))
    prob, v = _cast(dtype, e / e.sum(-1, keepdim=True), v)
    return linear(w, f"{p}.proj", torch.matmul(prob, v).transpose(1, 2).reshape(b, t, d), dtype)


def mlp(w, p, x, dtype):
    h = linear(w, f"{p}.fc1", x, dtype).float()
    return linear(w, f"{p}.fc2", 0.5 * h * (1.0 + torch.erf(h / math.sqrt(2.0))), dtype)


def embed(w, x, patch_size, padding, dtype):
    """(B, H, W, 3) NHWC → tokens (B, T, D) float32 with the position
    embedding, and the grid (Hp, Wp)."""
    xin, weight, bias = _cast(dtype, x.permute(0, 3, 1, 2), w["backbone.patch_embed.proj.weight"],
                              w["backbone.patch_embed.proj.bias"])
    y = F.conv2d(xin, weight, bias, patch_size, padding)
    pos = w["backbone.pos_embed"]
    return y.flatten(2).transpose(1, 2).float() + pos[:, 1:] + pos[:, :1], y.shape[2:]


def heatmaps(w, x, depth, num_heads, patch_size=16, padding=2, num_deconv=2, dtype="float32"):
    """(B, H, W, 3) NHWC normalised crops → (B, H/4, W/4, K) float32."""
    t, (hp, wp) = embed(w, x, patch_size, padding, dtype)
    for i in range(depth):
        p = f"backbone.blocks.{i}"
        t = t + attention(w, f"{p}.attn", layer_norm(w, f"{p}.norm1", t), num_heads, dtype).float()
        t = t + mlp(w, f"{p}.mlp", layer_norm(w, f"{p}.norm2", t), dtype).float()
    y = layer_norm(w, "backbone.last_norm", t).transpose(1, 2).reshape(t.shape[0], t.shape[2], hp, wp)
    for j in range(num_deconv):
        yin, weight = _cast(dtype, y, w[f"keypoint_head.deconv_layers.{3 * j}.weight"])
        y = F.conv_transpose2d(yin, weight, None, 2, 1).float()
        bn = f"keypoint_head.deconv_layers.{3 * j + 1}"
        y = (y - w[f"{bn}.running_mean"][:, None, None]) / torch.sqrt(w[f"{bn}.running_var"][:, None, None] + BN_EPS)
        y = F.relu(y * w[f"{bn}.weight"][:, None, None] + w[f"{bn}.bias"][:, None, None])
    yin, weight, bias = _cast(dtype, y, w["keypoint_head.final_layer.weight"], w["keypoint_head.final_layer.bias"])
    return F.conv2d(yin, weight, bias).float().permute(0, 2, 3, 1)
