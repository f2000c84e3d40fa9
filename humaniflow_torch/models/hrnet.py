"""Pose HRNet-W48 2D keypoint detector, eval mode.

The PyTorch counterpart of `humaniflow_tpu/models/hrnet.py` (reference
PoseHighResolutionNet): stem → 4 Bottlenecks → three multi-resolution
stages of BASIC blocks ([48, 96, 192, 384] channels, [1, 4, 3] modules) with
full cross-resolution fuse layers → 17 COCO-keypoint heatmaps.  Input
384×288 (H×W), heatmaps 96×72.

Module names follow the JAX package's (stage{S}_module{M}.branch{B}_block{K},
fuse{i}_{j}_conv{k}, transition{T}_{B}_conv, ...), so that weights carry
across by name (utils/convert_jax.py::hrnet_params_from_jax) and the
reference checkpoint's names map mechanically (utils/load_reference.py).
The public call takes NHWC and returns NHWC heatmaps, as the JAX module
does; inside it runs NCHW.  BatchNorm runs on its running statistics (eps
1e-5).  Convolutions run under cuDNN with TF32 off.

`dtype=torch.bfloat16` matches flax's `dtype`: every convolution runs in
bf16 (weights kept in float32 and cast), BatchNorm and everything between
the convolutions run in float32, and the heatmaps are float32.
"""

from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.device import resolve_device
from .resnet import fp32_convolutions

STAGE_CHANNELS = (48, 96, 192, 384)
STAGE_MODULES = (1, 4, 3)  # stages 2, 3, 4
STAGE_BLOCKS = 4  # BASIC blocks per branch
NUM_JOINTS = 17


class Conv(nn.Conv2d):
    """A convolution that computes in the network's dtype (None: float32)."""

    def __init__(self, in_ch, out_ch, k, stride=1, bias=False, dtype=None, padding=None):
        super().__init__(in_ch, out_ch, k, stride, padding=k // 2 if padding is None else padding, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x):
        if self.compute_dtype is None:
            return super().forward(x)
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.conv2d(x.to(dt), self.weight.to(dt), bias, self.stride, self.padding)


class BatchNorm(nn.BatchNorm2d):
    """Eval-mode BatchNorm (eps 1e-5) applied in float32."""

    def __init__(self, c):
        super().__init__(c, eps=1e-5)

    def forward(self, x):
        return super().forward(x.float())


class BasicBlock(nn.Module):
    def __init__(self, features: int, dtype=None):
        super().__init__()
        self.conv1 = Conv(features, features, 3, dtype=dtype)
        self.bn1 = BatchNorm(features)
        self.conv2 = Conv(features, features, 3, dtype=dtype)
        self.bn2 = BatchNorm(features)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return F.relu(y + x)


class Bottleneck(nn.Module):
    def __init__(self, in_ch: int, features: int, dtype=None):
        super().__init__()
        out = features * 4
        self.conv1 = Conv(in_ch, features, 1, dtype=dtype)
        self.bn1 = BatchNorm(features)
        self.conv2 = Conv(features, features, 3, dtype=dtype)
        self.bn2 = BatchNorm(features)
        self.conv3 = Conv(features, out, 1, dtype=dtype)
        self.bn3 = BatchNorm(out)
        if in_ch != out:
            self.downsample_conv = Conv(in_ch, out, 1, dtype=dtype)
            self.downsample_bn = BatchNorm(out)
        else:
            self.downsample_conv = None

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = x if self.downsample_conv is None else self.downsample_bn(self.downsample_conv(x))
        return F.relu(y + residual)


def _upsample_nearest(x, factor: int):
    """Nearest upsampling by an integer factor (NCHW), as jax.image.resize's
    'nearest' at integer scale: output pixel o reads input floor(o / factor)."""
    return x.repeat_interleave(factor, dim=2).repeat_interleave(factor, dim=3)


class HighResolutionModule(nn.Module):
    """Per-branch BASIC-block stacks and full cross-resolution fusion."""

    def __init__(self, num_branches: int, channels: Sequence[int], multi_scale_output: bool = True, dtype=None):
        super().__init__()
        self.num_branches = num_branches
        self.num_out = num_branches if multi_scale_output else 1
        for b in range(num_branches):
            for k in range(STAGE_BLOCKS):
                self.add_module(f"branch{b}_block{k}", BasicBlock(channels[b], dtype))
        for i in range(self.num_out):
            for j in range(num_branches):
                if j > i:
                    self.add_module(f"fuse{i}_{j}_conv", Conv(channels[j], channels[i], 1, dtype=dtype))
                    self.add_module(f"fuse{i}_{j}_bn", BatchNorm(channels[i]))
                elif j < i:
                    for k in range(i - j):
                        out_ch = channels[i] if k == i - j - 1 else channels[j]
                        self.add_module(f"fuse{i}_{j}_conv{k}", Conv(channels[j], out_ch, 3, 2, dtype=dtype))
                        self.add_module(f"fuse{i}_{j}_bn{k}", BatchNorm(out_ch))

    def forward(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        ys = []
        for b in range(self.num_branches):
            y = xs[b]
            for k in range(STAGE_BLOCKS):
                y = getattr(self, f"branch{b}_block{k}")(y)
            ys.append(y)
        fused = []
        for i in range(self.num_out):
            acc = None
            for j in range(self.num_branches):
                if j == i:
                    v = ys[j]
                elif j > i:
                    v = getattr(self, f"fuse{i}_{j}_bn")(getattr(self, f"fuse{i}_{j}_conv")(ys[j]))
                    v = _upsample_nearest(v, 2 ** (j - i))
                else:
                    v = ys[j]
                    for k in range(i - j):
                        v = getattr(self, f"fuse{i}_{j}_bn{k}")(getattr(self, f"fuse{i}_{j}_conv{k}")(v))
                        if k != i - j - 1:
                            v = F.relu(v)
                acc = v if acc is None else acc + v
            fused.append(F.relu(acc))
        return fused


class PoseHighResolutionNet(nn.Module):
    """HRNet-W48: (B, H, W, 3) NHWC → (B, H/4, W/4, 17) heatmaps, float32."""

    def __init__(
        self,
        num_joints: int = NUM_JOINTS,
        dtype: Optional[torch.dtype] = None,
        device=None,
        generator: Optional[torch.Generator] = None,
    ):
        """:param dtype: None or torch.float32 for float32 convolutions, or
            torch.bfloat16.
        :param device: default CUDA; raises if CUDA is unavailable.
        :param generator: CPU generator for the random init (seed 0 if None)."""
        super().__init__()
        device = resolve_device(device)
        if dtype == torch.float32:
            dtype = None
        if dtype not in (None, torch.bfloat16):
            raise ValueError(f"dtype must be None, torch.float32 or torch.bfloat16, got {dtype}")
        self.dtype = dtype
        c = STAGE_CHANNELS
        self.conv1 = Conv(3, 64, 3, 2, dtype=dtype)
        self.bn1 = BatchNorm(64)
        self.conv2 = Conv(64, 64, 3, 2, dtype=dtype)
        self.bn2 = BatchNorm(64)
        for k in range(4):
            self.add_module(f"layer1_block{k}", Bottleneck(64 if k == 0 else 256, 64, dtype))
        self.transition1_0_conv = Conv(256, c[0], 3, dtype=dtype)
        self.transition1_0_bn = BatchNorm(c[0])
        self.transition1_1_conv = Conv(256, c[1], 3, 2, dtype=dtype)
        self.transition1_1_bn = BatchNorm(c[1])
        self.transition2_2_conv = Conv(c[1], c[2], 3, 2, dtype=dtype)
        self.transition2_2_bn = BatchNorm(c[2])
        self.transition3_3_conv = Conv(c[2], c[3], 3, 2, dtype=dtype)
        self.transition3_3_bn = BatchNorm(c[3])
        for s, n_modules in zip((2, 3, 4), STAGE_MODULES):
            for m in range(n_modules):
                multi = not (s == 4 and m == n_modules - 1)
                self.add_module(f"stage{s}_module{m}", HighResolutionModule(s, c[:s], multi, dtype))
        self.final_layer = Conv(c[0], num_joints, 1, bias=True, dtype=dtype)
        self.reset_parameters(generator if generator is not None else torch.Generator().manual_seed(0))
        self.eval()
        self.to(device)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator):
        """LeCun-normal conv kernels (std 1/√fan_in, as flax's default), zero
        conv biases and identity BatchNorm."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                m.weight.normal_(0.0, m.weight[0].numel() ** -0.5, generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
                m.reset_running_stats()

    @property
    def device(self) -> torch.device:
        return self.conv1.weight.device

    def _stage(self, s: int, xs):
        for m in range(STAGE_MODULES[s - 2]):
            xs = getattr(self, f"stage{s}_module{m}")(xs)
        return xs

    def forward(self, x):
        with fp32_convolutions():
            x = x.permute(0, 3, 1, 2)
            x = F.relu(self.bn1(self.conv1(x)))
            x = F.relu(self.bn2(self.conv2(x)))
            for k in range(4):
                x = getattr(self, f"layer1_block{k}")(x)
            xs = [
                F.relu(self.transition1_0_bn(self.transition1_0_conv(x))),
                F.relu(self.transition1_1_bn(self.transition1_1_conv(x))),
            ]
            xs = self._stage(2, xs)
            xs = xs + [F.relu(self.transition2_2_bn(self.transition2_2_conv(xs[-1])))]
            xs = self._stage(3, xs)
            xs = xs + [F.relu(self.transition3_3_bn(self.transition3_3_conv(xs[-1])))]
            xs = self._stage(4, xs)
            out = self.final_layer(xs[0])
        return out.float().permute(0, 2, 3, 1)


def get_kp_locations_confs_from_heatmaps(heatmaps: torch.Tensor):
    """Argmax decode: heatmaps (B, H, W, K) → keypoints (B, K, 2) in heatmap
    coordinates (x, y) and confidences (B, K); a tie goes to the first
    maximum, as jnp.argmax."""
    b, h, w, k = heatmaps.shape
    flat = heatmaps.reshape(b, h * w, k)
    confs = flat.amax(dim=1)
    idx = flat.argmax(dim=1)
    x = (idx % w).float()
    y = torch.floor(idx.float() / w)
    return torch.stack([x, y], dim=-1), confs
