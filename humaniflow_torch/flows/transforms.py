"""Flow transforms: the forward (base → data) and inverse directions.

The PyTorch counterpart of the transforms in `humaniflow_tpu/flows/
transforms.py` that the default `NormFlowConfig` builds: permutation,
conditional spline coupling and scaled radial tanh.  Each module's
`forward(x, context, parts)` returns y without a log-det (the sampling path
does not use it); `inverse(y, context, parts)` returns (x, log|dy/dx| at x),
reduced over the event dim, as the JAX transforms' `inverse` does.  `parts`
selects the per-part weights of the part-stacked hypernets (see
dense_nn.py).
"""

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from .dense_nn import DenseNN
from .spline import monotonic_rational_spline_forward, monotonic_rational_spline_inverse


class Permute(nn.Module):
    """Fixed permutation of event dims."""

    def __init__(self, permutation: Tuple[int, ...]):
        super().__init__()
        self.permutation = tuple(permutation)

    def forward(self, x, context=None, parts=None):
        return x[..., list(self.permutation)]

    def inverse(self, y, context=None, parts=None):
        inv = [0] * len(self.permutation)
        for i, p in enumerate(self.permutation):
            inv[p] = i
        return y[..., inv], y.new_zeros(y.shape[:-1])


class ConditionalSplineCoupling(nn.Module):
    """Conditional coupling with a monotonic linear-rational spline: the
    first split_dim dims pass through; a hypernet over
    concat([context, x_lower]) emits spline params for the remaining dims."""

    def __init__(
        self,
        input_dim: int,
        context_dim: int,
        hidden_dims: Sequence[int],
        num_parts: int,
        count_bins: int = 8,
        bound: float = 3.0,
        split_dim: Optional[int] = None,
    ):
        super().__init__()
        self.split = input_dim // 2 if split_dim is None else split_dim
        self.upper = input_dim - self.split
        self.count_bins = count_bins
        self.bound = bound
        u, k = self.upper, count_bins
        self.hypernet = DenseNN(
            self.split, context_dim, hidden_dims, (u * k, u * k, u * (k - 1), u * k), num_parts
        )

    def _spline_params(self, x1, context, parts):
        u, k = self.upper, self.count_bins
        w, h, d, l = self.hypernet(x1, context, parts)
        shape = w.shape[:-1]
        return (
            w.reshape(shape + (u, k)),
            h.reshape(shape + (u, k)),
            d.reshape(shape + (u, k - 1)),
            l.reshape(shape + (u, k)),
        )

    def forward(self, x, context, parts):
        s = self.split
        x1, x2 = x[..., :s], x[..., s:]
        y2 = monotonic_rational_spline_forward(x2, *self._spline_params(x1, context, parts), bound=self.bound)
        return torch.cat([x1, y2], dim=-1)

    def inverse(self, y, context, parts):
        s = self.split
        y1, y2 = y[..., :s], y[..., s:]
        x2, ld_inv = monotonic_rational_spline_inverse(y2, *self._spline_params(y1, context, parts), bound=self.bound)
        # the spline gives log|dx/dy|; negated, log|dy/dx|
        return torch.cat([y1, x2], dim=-1), -torch.sum(ld_inv, dim=-1)


class ScaledRadialTanh(nn.Module):
    """Radial compactification y = (x/‖x‖)·R·tanh(‖x‖/R) onto the open ball
    of radius R."""

    def __init__(self, radius: float):
        super().__init__()
        self.radius = radius

    def forward(self, x, context=None, parts=None):
        r = self.radius
        norm_sq = torch.sum(x * x, dim=-1, keepdim=True)
        small = norm_sq < 1e-14
        norm = torch.sqrt(torch.where(small, torch.ones_like(norm_sq), norm_sq))
        scale = torch.where(small, torch.ones_like(norm), torch.tanh(norm / r) * r / norm)
        return x * scale

    def inverse(self, y, context=None, parts=None):
        r = self.radius
        norm_sq = torch.sum(y * y, dim=-1, keepdim=True)
        small = norm_sq < 1e-14
        norm = torch.sqrt(torch.where(small, torch.ones_like(norm_sq), norm_sq))
        # atanh blows up at ‖y‖ → R: clamp strictly inside the ball
        ratio = torch.clamp(norm / r, 0.0, 1.0 - 1e-6)
        scale = torch.where(small, torch.ones_like(norm), torch.atanh(ratio) * r / norm)
        ratio_sq = torch.clamp(ratio[..., 0] ** 2, 0.0, 1.0 - 1e-7)
        ld = torch.where(
            small[..., 0],
            torch.zeros_like(ratio_sq),
            -2.0 * torch.log(torch.clamp(scale[..., 0], min=1e-30)) + torch.log1p(-ratio_sq),
        )
        return y * scale, ld
