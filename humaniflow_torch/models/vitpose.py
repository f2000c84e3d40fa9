"""ViTPose top-down 2D keypoint detector, eval mode.

Xu, Zhang, Zhang and Tao, "ViTPose: Simple Vision Transformer Baselines for
Human Pose Estimation", NeurIPS 2022; the published ViTPose-H
(`configs/body/2d_kpt_sview_rgb_img/topdown_heatmap/coco/
ViTPose_huge_coco_256x192.py`, backbone `mmpose/models/backbones/vit.py`,
head `TopdownHeatmapSimpleHead`):

* patch embedding `Conv2d(3, D, k=16, s=16, padding=2)`: a 256×192 crop
  gives a 16×12 grid, T = 192 tokens; the absolute position embedding has
  T + 1 rows and row 0 is added to every token
  (`x + pos_embed[:, 1:] + pos_embed[:, :1]`), with no class token;
* `depth` pre-LN blocks: x + proj(MHSA(LN1(x))) with qkv bias, scale
  head_dim^-1/2, then x + fc2(GELU(fc1(LN2(x)))), exact (erf) GELU,
  LayerNorm eps 1e-6; drop-path is training-only, the identity here;
* `last_norm`, the tokens back to a (B, D, 16, 12) map, then the head: two
  `ConvTranspose2d(·, 256, k=4, s=2, p=1, bias=False)` + BatchNorm + ReLU
  (64×48), then `Conv2d(256, 17, k=1)` with bias.

Module and parameter names are mmpose's (`backbone.blocks.{i}.attn.qkv`,
`keypoint_head.deconv_layers.{0,1,3,4}`, ...), so a released checkpoint
loads by name (utils/load_reference.py::load_vitpose_checkpoint).  The
public call takes NHWC normalised crops and returns NHWC heatmaps, float32,
as PoseHighResolutionNet does; the net declares its crop and heatmap sizes
(`input_wh`, `heatmap_wh`, (width, height)), which the keypoint stage reads
(pipelines/predict_hrnet.py).

`dtype=torch.bfloat16`: every matrix product (the linears, attention
through `scaled_dot_product_attention`, the patch embedding, the head's
convolutions) runs in bf16 with the weights kept in float32 and cast; the
residual stream, LayerNorm, the softmax statistics, BatchNorm and the
heatmaps are float32.  With dtype None everything is float32 (TF32 off for
the convolutions; matmuls as the port leaves them, full float32).

Spans (utils/tracing.py): `vitpose.embed`, `vitpose.blocks` (counter
`vit_tokens`, B·T through the blocks) and `vitpose.head` (the last
LayerNorm and the deconvolution head).
"""

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.device import resolve_device
from ..utils.tracing import count, span
from .hrnet import BatchNorm, Conv
from .resnet import fp32_convolutions

# ViTPose-H at 256×192 (the published config); keyword arguments of ViTPose
VITPOSE_H = dict(embed_dim=1280, depth=32, num_heads=16, mlp_ratio=4, qkv_bias=True, img_size=(256, 192),
                 patch_size=16, patch_padding=2, deconv_filters=(256, 256), num_joints=17)
LN_EPS = 1e-6


class Linear(nn.Linear):
    """A linear layer that computes in the network's dtype (None: float32)."""

    def __init__(self, in_f: int, out_f: int, bias: bool = True, dtype=None):
        super().__init__(in_f, out_f, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x)
        return F.linear(x.to(dt), self.weight.to(dt), None if self.bias is None else self.bias.to(dt))


class Deconv(nn.ConvTranspose2d):
    """`ConvTranspose2d(k=4, s=2, p=1)` without bias, in the network's dtype."""

    def __init__(self, in_ch, out_ch, dtype=None):
        super().__init__(in_ch, out_ch, 4, stride=2, padding=1, output_padding=0, bias=False)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x)
        return F.conv_transpose2d(x.to(dt), self.weight.to(dt), None, self.stride, self.padding)


class PatchEmbed(nn.Module):
    def __init__(self, patch_size: int, padding: int, embed_dim: int, dtype=None):
        super().__init__()
        self.proj = Conv(3, embed_dim, patch_size, patch_size, bias=True, dtype=dtype, padding=padding)

    def forward(self, x):
        """(B, 3, H, W) → tokens (B, Hp·Wp, D) in row-major grid order, Hp, Wp."""
        x = self.proj(x)
        hp, wp = x.shape[2], x.shape[3]
        return x.flatten(2).transpose(1, 2), hp, wp


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int, qkv_bias: bool, dtype=None):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = Linear(dim, 3 * dim, bias=qkv_bias, dtype=dtype)
        self.proj = Linear(dim, dim, dtype=dtype)

    def forward(self, x):
        b, t, d = x.shape
        qkv = self.qkv(x).reshape(b, t, 3, self.num_heads, d // self.num_heads).permute(2, 0, 3, 1, 4)
        y = F.scaled_dot_product_attention(qkv[0], qkv[1], qkv[2])  # scale head_dim^-1/2
        return self.proj(y.transpose(1, 2).reshape(b, t, d))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, dtype=None):
        super().__init__()
        self.fc1 = Linear(dim, hidden, dtype=dtype)
        self.fc2 = Linear(hidden, dim, dtype=dtype)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class Block(nn.Module):
    """Pre-LN transformer block on the float32 residual stream."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float, qkv_bias: bool, dtype=None):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = Attention(dim, num_heads, qkv_bias, dtype)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))  # a bf16 branch is promoted to float32 by the addition
        return x + self.mlp(self.norm2(x))


class ViT(nn.Module):
    """The backbone: patch embedding, position embedding, blocks, last_norm."""

    def __init__(self, img_size, patch_size, patch_padding, embed_dim, depth, num_heads, mlp_ratio, qkv_bias,
                 dtype=None):
        super().__init__()
        self.patch_embed = PatchEmbed(patch_size, patch_padding, embed_dim, dtype)
        num_patches = (img_size[0] // patch_size) * (img_size[1] // patch_size)
        self.pos_embed = nn.Parameter(torch.zeros(1, num_patches + 1, embed_dim))
        self.blocks = nn.ModuleList(Block(embed_dim, num_heads, mlp_ratio, qkv_bias, dtype) for _ in range(depth))
        self.last_norm = nn.LayerNorm(embed_dim, eps=LN_EPS)

    def embed(self, x):
        """(B, 3, H, W) → tokens (B, T, D) with the position embedding, float32; Hp, Wp."""
        tokens, hp, wp = self.patch_embed(x)
        return tokens + self.pos_embed[:, 1:] + self.pos_embed[:, :1], hp, wp


class TopdownHeatmapSimpleHead(nn.Module):
    """Two deconvolutions (each + BatchNorm + ReLU) and a 1×1 convolution."""

    def __init__(self, in_ch: int, filters: Tuple[int, ...], num_joints: int, dtype=None):
        super().__init__()
        layers = []
        for f in filters:
            layers += [Deconv(in_ch, f, dtype), BatchNorm(f), nn.ReLU()]
            in_ch = f
        self.deconv_layers = nn.Sequential(*layers)
        self.final_layer = Conv(in_ch, num_joints, 1, bias=True, dtype=dtype)

    def forward(self, x):
        return self.final_layer(self.deconv_layers(x))


class ViTPose(nn.Module):
    """ViTPose: (B, H, W, 3) NHWC normalised crops → (B, H/4, W/4, K)
    heatmaps, float32."""

    span_name = "vitpose"  # the keypoint stage's spans: vitpose, vitpose.upload, ...

    def __init__(self, *, embed_dim: int, depth: int, num_heads: int, mlp_ratio: float, qkv_bias: bool,
                 img_size: Tuple[int, int], patch_size: int, patch_padding: int, deconv_filters: Tuple[int, ...],
                 num_joints: int, dtype: Optional[torch.dtype] = None, device=None,
                 generator: Optional[torch.Generator] = None):
        """The widths are keyword arguments (ViTPose-H's: `VITPOSE_H`).

        :param img_size: the crop (height, width).
        :param dtype: None or torch.float32 for float32 products, or torch.bfloat16.
        :param device: default CUDA; raises if CUDA is unavailable.
        :param generator: a generator on `device` for the random init (seed 0 if None)."""
        super().__init__()
        device = resolve_device(device)
        if dtype == torch.float32:
            dtype = None
        if dtype not in (None, torch.bfloat16):
            raise ValueError(f"dtype must be None, torch.float32 or torch.bfloat16, got {dtype}")
        self.dtype = dtype
        h, w = img_size
        grid = [(n + 2 * patch_padding - patch_size) // patch_size + 1 for n in (w, h)]
        self.input_wh = (w, h)
        self.heatmap_wh = tuple(n * 2 ** len(deconv_filters) for n in grid)  # each deconvolution doubles
        with torch.device(device):
            self.backbone = ViT(img_size, patch_size, patch_padding, embed_dim, depth, num_heads, mlp_ratio, qkv_bias,
                                dtype)
            self.keypoint_head = TopdownHeatmapSimpleHead(embed_dim, tuple(deconv_filters), num_joints, dtype)
        self.reset_parameters(generator if generator is not None else torch.Generator(device).manual_seed(0))
        self.eval()

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator):
        """The published initialisation: linear weights and the position
        embedding N(0, 0.02²) (timm's trunc_normal_ cuts at ±2, 100σ away),
        zero linear biases, unit LayerNorm; the patch embedding as PyTorch's
        default Conv2d, U(±1/√fan_in); the head's deconvolutions and final
        convolution N(0, 0.001²), zero final bias, identity BatchNorm."""
        for m in self.modules():
            if isinstance(m, nn.Linear):
                m.weight.normal_(0.0, 0.02, generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.LayerNorm):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
            elif isinstance(m, nn.BatchNorm2d):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
                m.reset_running_stats()
        self.backbone.pos_embed.normal_(0.0, 0.02, generator=generator)
        proj = self.backbone.patch_embed.proj
        bound = 1.0 / math.sqrt(proj.weight[0].numel())
        for p in (proj.weight, proj.bias):
            p.uniform_(-bound, bound, generator=generator)
        for m in self.keypoint_head.modules():
            if isinstance(m, (nn.ConvTranspose2d, nn.Conv2d)):
                m.weight.normal_(0.0, 0.001, generator=generator)
                if m.bias is not None:
                    m.bias.zero_()

    @property
    def device(self) -> torch.device:
        return self.backbone.pos_embed.device

    def forward(self, x):
        bb = self.backbone
        with fp32_convolutions():
            with span("vitpose.embed"):
                x, hp, wp = bb.embed(x.permute(0, 3, 1, 2))
            with span("vitpose.blocks"):
                count("vit_tokens", x.shape[0] * x.shape[1])
                for blk in bb.blocks:
                    x = blk(x)
            with span("vitpose.head"):
                x = bb.last_norm(x)
                x = x.transpose(1, 2).reshape(x.shape[0], x.shape[2], hp, wp)
                out = self.keypoint_head(x)
        return out.float().permute(0, 2, 3, 1)
