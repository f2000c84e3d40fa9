"""ResNet image encoder (feature extractor, no FC head).

The PyTorch counterpart of `humaniflow_tpu/models/resnet.py`.  Module names
mirror the JAX package's (conv1, bn1, layer{i}_block{j}, conv1/bn1/...,
downsample_conv/downsample_bn) so that weights carry across by name
(utils/convert_jax.py).  The public call takes NHWC, as the JAX encoder
does, and permutes to NCHW inside.  In eval mode BatchNorm runs on its
running statistics (eps 1e-5); in train mode it normalises with the batch
statistics and updates the running ones as flax's BatchNorm(momentum=0.9)
does (see BatchNorm).  Convolutions run in full float32: cuDNN's TF32 is
switched off around the forward (see fp32_convolutions).
"""

import contextlib
from typing import Sequence, Type

import torch
import torch.nn.functional as F
from torch import nn

RESNET_FEAT_DIMS = {18: 512, 50: 2048}


@contextlib.contextmanager
def fp32_convolutions():
    """Run cuDNN convolutions in full float32 (no TF32), leaving every other
    cuDNN setting as the caller had it."""
    cudnn = torch.backends.cudnn
    with cudnn.flags(
        enabled=cudnn.enabled,
        benchmark=cudnn.benchmark,
        deterministic=cudnn.deterministic,
        allow_tf32=False,
    ):
        yield


FLAX_MOMENTUM = 0.9  # flax BatchNorm: running = 0.9·running + 0.1·batch


class BatchNorm(nn.BatchNorm2d):
    """nn.BatchNorm2d whose train-mode update follows flax: torch updates
    running_var with the unbiased batch variance, flax with the biased one
    (the variance it normalises with).  Train mode normalises with the batch
    statistics (F.batch_norm) and updates the running statistics itself,
    outside autograd."""

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        out = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
            self.running_mean.mul_(FLAX_MOMENTUM).add_(mean, alpha=1.0 - FLAX_MOMENTUM)
            self.running_var.mul_(FLAX_MOMENTUM).add_(var, alpha=1.0 - FLAX_MOMENTUM)
        return out


def _bn(c: int) -> BatchNorm:
    return BatchNorm(c, eps=1e-5)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_ch: int, features: int, strides: int):
        super().__init__()
        self.conv1 = nn.Conv2d(in_ch, features, 3, strides, padding=1, bias=False)
        self.bn1 = _bn(features)
        self.conv2 = nn.Conv2d(features, features, 3, 1, padding=1, bias=False)
        self.bn2 = _bn(features)
        if strides != 1 or in_ch != features:
            self.downsample_conv = nn.Conv2d(in_ch, features, 1, strides, bias=False)
            self.downsample_bn = _bn(features)
        else:
            self.downsample_conv = None

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        residual = x if self.downsample_conv is None else self.downsample_bn(self.downsample_conv(x))
        return F.relu(y + residual)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, in_ch: int, features: int, strides: int):
        super().__init__()
        out = features * 4
        self.conv1 = nn.Conv2d(in_ch, features, 1, bias=False)
        self.bn1 = _bn(features)
        self.conv2 = nn.Conv2d(features, features, 3, strides, padding=1, bias=False)
        self.bn2 = _bn(features)
        self.conv3 = nn.Conv2d(features, out, 1, bias=False)
        self.bn3 = _bn(out)
        if strides != 1 or in_ch != out:
            self.downsample_conv = nn.Conv2d(in_ch, out, 1, strides, bias=False)
            self.downsample_bn = _bn(out)
        else:
            self.downsample_conv = None

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = x if self.downsample_conv is None else self.downsample_bn(self.downsample_conv(x))
        return F.relu(y + residual)


class ResNet(nn.Module):
    """Feature-extractor ResNet: (B, H, W, C) NHWC → pooled (B, feat) features."""

    def __init__(self, stage_sizes: Sequence[int], block: Type[nn.Module], in_channels: int):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channels, 64, 7, 2, padding=3, bias=False)
        self.bn1 = _bn(64)
        self.blocks = nn.ModuleDict()
        in_ch = 64
        for i, num_blocks in enumerate(stage_sizes):
            features = 64 * 2**i
            for j in range(num_blocks):
                strides = 2 if i > 0 and j == 0 else 1
                self.blocks[f"layer{i + 1}_block{j}"] = block(in_ch, features, strides)
                in_ch = features * block.expansion
        self.eval()

    def reset_parameters(self, generator: torch.Generator):
        """LeCun-normal conv kernels (std 1/√fan_in, as flax's default) and
        identity BatchNorm."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                fan_in = m.weight[0].numel()
                m.weight.data.normal_(0.0, fan_in**-0.5, generator=generator)
            elif isinstance(m, nn.BatchNorm2d):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
                m.reset_running_stats()

    def forward(self, x):
        # oneDNN's CPU convolutions give train-mode gradients ~1e-2 off a
        # float64 reference (PyTorch's own CPU kernels: 5e-5, as JAX's), so
        # training on the CPU runs without oneDNN
        exact_cpu = x.device.type == "cpu" and self.training and torch.is_grad_enabled()
        no_onednn = torch.backends.mkldnn.flags(enabled=False) if exact_cpu else contextlib.nullcontext()
        with fp32_convolutions(), no_onednn:
            x = x.permute(0, 3, 1, 2)
            x = F.relu(self.bn1(self.conv1(x)))
            x = F.max_pool2d(x, 3, 2, padding=1)
            for blk in self.blocks.values():
                x = blk(x)
        return x.mean(dim=(2, 3))


def resnet18(in_channels: int = 18) -> ResNet:
    return ResNet((2, 2, 2, 2), BasicBlock, in_channels)


def resnet50(in_channels: int = 18) -> ResNet:
    return ResNet((3, 4, 6, 3), Bottleneck, in_channels)
