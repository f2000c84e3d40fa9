"""Conditional normalizing-flow factory and the flow's forward pass.

The PyTorch counterpart of `humaniflow_tpu/flows/factory.py`: base
Independent-Normal(0, σ²I) → per block [permute | linear PLU | conditional
linear PLU] → [BatchNorm] → conditional transform (spline, additive or
affine coupling, masked affine or spline) → final radial-tanh
compactification, with every part's weights stacked on a leading body-part
axis: the forward pass (sampling), `log_prob` (density, training) and the
BatchNorm layers' running-statistics update.
"""

import math
from typing import Optional, Sequence

import torch
from torch import nn

from .autoregressive import ConditionalAffineAutoregressive, ConditionalSplineAutoregressive, FlowBatchNorm
from .transforms import (
    ConditionalAdditiveCoupling,
    ConditionalAffineCoupling,
    ConditionalLinearPLU,
    ConditionalSplineCoupling,
    LinearPLU,
    Permute,
    ScaledRadialTanh,
)

TRANSFORM_TYPES = ("spline_coupling", "spline_masked", "additive_coupling", "affine_coupling", "affine_masked")
PERMUTE_TYPES = (None, "permute", "linear_plu", "conditional_linear_plu")


class ConditionalFlow(nn.Module):
    """A conditional flow on R^event_dim: z ~ N(0, σ²I) → transforms → y."""

    def __init__(self, transforms: Sequence[nn.Module], event_dim: int, base_dist_std: float):
        super().__init__()
        self.transforms = nn.ModuleList(transforms)
        self.event_dim = event_dim
        self.base_dist_std = base_dist_std

    def forward(self, base_sample, context, parts):
        """Push base samples (..., P, event_dim) through all transforms under
        contexts (..., P, C) of the parts `parts` (LongTensor (P,))."""
        x = base_sample
        for t in self.transforms:
            x = t(x, context, parts)
        return x

    def log_prob(self, y, context, parts):
        """log p(y | context) of points y (..., P, event_dim): the inverse
        through every transform, the Normal base log-prob minus the summed
        forward log-dets.  :return: (..., P)."""
        x = y
        total_ld = y.new_zeros(y.shape[:-1])
        for t in reversed(self.transforms):
            x, ld = t.inverse(x, context, parts)
            total_ld = total_ld + ld
        var = self.base_dist_std**2
        base_lp = torch.sum(-0.5 * (x * x) / var - 0.5 * math.log(2 * math.pi * var), dim=-1)
        return base_lp - total_ld

    @property
    def has_batch_norm(self) -> bool:
        return any(isinstance(t, FlowBatchNorm) for t in self.transforms)

    @torch.no_grad()
    def update_batchnorm_stats(self, y, context):
        """Move every BatchNorm layer's running statistics towards a training
        batch, in place: the density-direction chain from y (..., P,
        event_dim) of every part, in order, each BatchNorm layer normalising
        with the batch's statistics as it updates them.  No-op without
        BatchNorm layers."""
        if not self.has_batch_norm:
            return
        parts = torch.arange(y.shape[-2], device=y.device)
        x = y
        for t in reversed(self.transforms):
            if isinstance(t, FlowBatchNorm):
                x = t.update_stats(x)
            else:
                x, _ = t.inverse(x, context, parts)


def create_conditional_norm_flow(
    event_dim: int,
    context_dim: int,
    num_transforms: int,
    num_parts: int,
    transform_type: str = "spline_coupling",
    transform_hidden_dims: Sequence[int] = (64, 32, 32),
    permute_type: Optional[str] = "permute",
    permute_hidden_dims: Optional[Sequence[int]] = None,
    batch_norm: bool = False,
    radial_tanh_radius: Optional[float] = None,
    base_dist_std: float = 1.0,
    count_bins: int = 8,
    bound: float = 3.0,
) -> ConditionalFlow:
    """Build the flow, with the JAX factory's menu.  Permutations cycle
    through the cyclic shifts of range(event_dim), as in the JAX factory."""
    if transform_type not in TRANSFORM_TYPES:
        raise ValueError(f"transform_type {transform_type!r} not supported")
    if permute_type not in PERMUTE_TYPES:
        raise ValueError(f"permute_type {permute_type!r} not supported")
    hidden = tuple(transform_hidden_dims)
    common = dict(input_dim=event_dim, context_dim=context_dim, hidden_dims=hidden, num_parts=num_parts)
    transforms = []
    idx = list(range(event_dim))
    for i in range(num_transforms):
        k = i % event_dim
        perm = tuple(idx[k:] + idx[:k])
        if permute_type == "permute":
            transforms.append(Permute(perm))
        elif permute_type == "linear_plu":
            transforms.append(LinearPLU(input_dim=event_dim, num_parts=num_parts, permutation=perm))
        elif permute_type == "conditional_linear_plu":
            transforms.append(ConditionalLinearPLU(
                input_dim=event_dim, context_dim=context_dim, num_parts=num_parts, permutation=perm,
                hidden_dims=tuple(permute_hidden_dims or (event_dim * 10,) * 2),
            ))
        if batch_norm:
            transforms.append(FlowBatchNorm(input_dim=event_dim, num_parts=num_parts))
        if transform_type == "spline_coupling":
            transforms.append(ConditionalSplineCoupling(**common, count_bins=count_bins, bound=bound))
        elif transform_type == "additive_coupling":
            transforms.append(ConditionalAdditiveCoupling(**common))
        elif transform_type == "affine_coupling":
            transforms.append(ConditionalAffineCoupling(**common))
        elif transform_type == "affine_masked":
            transforms.append(ConditionalAffineAutoregressive(**common))
        else:
            transforms.append(ConditionalSplineAutoregressive(**common, count_bins=count_bins, bound=bound))
    if radial_tanh_radius is not None:
        transforms.append(ScaledRadialTanh(radius=radial_tanh_radius))
    return ConditionalFlow(transforms, event_dim=event_dim, base_dist_std=base_dist_std)
