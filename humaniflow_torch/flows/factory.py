"""Conditional normalizing-flow factory and the flow's forward pass.

The PyTorch counterpart of `humaniflow_tpu/flows/factory.py`: base
Independent-Normal(0, σ²I) → per block [permute → conditional coupling] →
final radial-tanh compactification, with every part's weights stacked on a
leading body-part axis: the forward pass (sampling) and `log_prob`
(density, training).
"""

import math
from typing import Optional, Sequence

import torch
from torch import nn

from .transforms import ConditionalSplineCoupling, Permute, ScaledRadialTanh


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


def create_conditional_norm_flow(
    event_dim: int,
    context_dim: int,
    num_transforms: int,
    num_parts: int,
    transform_type: str = "spline_coupling",
    transform_hidden_dims: Sequence[int] = (64, 32, 32),
    permute_type: Optional[str] = "permute",
    batch_norm: bool = False,
    radial_tanh_radius: Optional[float] = None,
    base_dist_std: float = 1.0,
    count_bins: int = 8,
    bound: float = 3.0,
) -> ConditionalFlow:
    """Build the flow.  Permutations cycle through the cyclic shifts of
    range(event_dim), as in the JAX factory.  Only the default transform
    menu (permute + spline coupling, no flow BatchNorm) is ported so far."""
    if transform_type != "spline_coupling":
        raise NotImplementedError(f"transform_type {transform_type!r} is not ported yet")
    if permute_type not in (None, "permute"):
        raise NotImplementedError(f"permute_type {permute_type!r} is not ported yet")
    if batch_norm:
        raise NotImplementedError("flow BatchNorm is not ported yet")
    transforms = []
    idx = list(range(event_dim))
    for i in range(num_transforms):
        if permute_type is not None:
            k = i % event_dim
            transforms.append(Permute(tuple(idx[k:] + idx[:k])))
        transforms.append(
            ConditionalSplineCoupling(
                input_dim=event_dim,
                context_dim=context_dim,
                hidden_dims=tuple(transform_hidden_dims),
                num_parts=num_parts,
                count_bins=count_bins,
                bound=bound,
            )
        )
    if radial_tanh_radius is not None:
        transforms.append(ScaledRadialTanh(radius=radial_tanh_radius))
    return ConditionalFlow(transforms, event_dim=event_dim, base_dist_std=base_dist_std)
