"""Masked autoregressive flow transforms and the flow BatchNorm layer.

The PyTorch counterpart of `humaniflow_tpu/flows/autoregressive.py`: the
factory's 'affine_masked' and 'spline_masked' transforms and its optional
BatchNorm layer.  A MADE hypernet (one masked MLP per parameter block) gives
every event dim's parameters from the dims before it, so the density
direction is one parallel pass and the sampling direction one pass per event
dim.  Every weight has a leading part axis, selected by `parts` as in
dense_nn.py.

FlowBatchNorm keeps its running statistics as parameters, as the JAX
package keeps them in its parameter pytree: the log-density's gradient
reaches them and the optimizer steps them before the training step's
moving-average update (`update_stats`) runs on the stepped values.
"""

from typing import Sequence

import numpy as np
import torch
from torch import nn

from .spline import monotonic_rational_spline_forward, monotonic_rational_spline_inverse


def made_masks(event_dim: int, hidden_dims: Sequence[int], context_dim: int):
    """Degree-based MADE masks, (out, in) per layer: the context has degree 0
    (seen by every unit), the inputs degrees 1..D, hidden units cycle
    through 1..D−1, and output d sees only degrees < d + 1."""
    in_deg = np.concatenate([np.zeros(context_dim), np.arange(1, event_dim + 1)])
    masks = []
    prev = in_deg
    for h in hidden_dims:
        deg = 1 + (np.arange(h) % max(event_dim - 1, 1))
        masks.append((prev[:, None] <= deg[None, :]).T)
        prev = deg
    out_deg = np.arange(1, event_dim + 1)
    masks.append((prev[:, None] < out_deg[None, :]).T)
    return [torch.from_numpy(m.astype(np.float32)) for m in masks]


class MADE(nn.Module):
    """One masked MLP per parameter block over concat([context, x]):
    weights[i] (num_parts, num_blocks, out, in), biases[i] (num_parts,
    num_blocks, out)."""

    def __init__(self, event_dim: int, context_dim: int, hidden_dims: Sequence[int], num_blocks: int,
                 num_parts: int):
        super().__init__()
        dims = [context_dim + event_dim] + list(hidden_dims) + [event_dim]
        self.weights = nn.ParameterList(
            nn.Parameter(torch.empty(num_parts, num_blocks, dims[i + 1], dims[i])) for i in range(len(dims) - 1)
        )
        self.biases = nn.ParameterList(
            nn.Parameter(torch.empty(num_parts, num_blocks, dims[i + 1])) for i in range(len(dims) - 1)
        )
        for i, m in enumerate(made_masks(event_dim, hidden_dims, context_dim)):
            self.register_buffer(f"mask_{i}", m, persistent=False)

    def reset_parameters(self, generator: torch.Generator):
        """torch.nn.Linear's default: U(±1/√fan_in) for weight and bias."""
        for w, b in zip(self.weights, self.biases):
            bound = 1.0 / w.shape[-1] ** 0.5
            w.data.uniform_(-bound, bound, generator=generator)
            b.data.uniform_(-bound, bound, generator=generator)

    def forward(self, x, context, parts):
        """:param x: (..., P, D); :param context: (..., P, C).
        :return: (..., P, D, num_blocks); block b of dim d is independent of
        x[..., d:]."""
        h = torch.cat([context.expand(x.shape[:-1] + context.shape[-1:]), x], dim=-1)
        h = h[..., None, :].expand(h.shape[:-1] + (self.weights[0].shape[1], h.shape[-1]))
        n_layers = len(self.weights)
        for i in range(n_layers):
            w = self.weights[i][parts] * getattr(self, f"mask_{i}")  # (P, nb, out, in)
            h = torch.einsum("...pbi,pboi->...pbo", h, w) + self.biases[i][parts]
            if i < n_layers - 1:
                h = torch.relu(h)
        return h.transpose(-1, -2)


class ConditionalAffineAutoregressive(nn.Module):
    """Conditional affine autoregressive transform ('affine_masked'):
    y_d = mean_d(y_<d) + exp(s_d(y_<d))·x_d, the log-scale clipped."""

    def __init__(self, input_dim: int, context_dim: int, hidden_dims: Sequence[int], num_parts: int,
                 log_scale_min_clip: float = -5.0, log_scale_max_clip: float = 3.0):
        super().__init__()
        self.input_dim = input_dim
        self.log_scale_min_clip = log_scale_min_clip
        self.log_scale_max_clip = log_scale_max_clip
        self.made = MADE(input_dim, context_dim, hidden_dims, 2, num_parts)

    def reset_parameters(self, generator: torch.Generator):
        self.made.reset_parameters(generator)

    def _params_at(self, x, context, parts):
        out = self.made(x, context, parts)
        return out[..., 0], torch.clamp(out[..., 1], self.log_scale_min_clip, self.log_scale_max_clip)

    def forward(self, x, context, parts):
        """Sampling direction: one MADE pass per event dim."""
        y = torch.zeros_like(x)
        for d in range(self.input_dim):
            mean, log_scale = self._params_at(y, context, parts)
            y = torch.cat([y[..., :d], (mean[..., d] + torch.exp(log_scale[..., d]) * x[..., d])[..., None],
                           y[..., d + 1:]], dim=-1)
        return y

    def inverse(self, y, context, parts):
        """Density direction: one parallel pass."""
        mean, log_scale = self._params_at(y, context, parts)
        return (y - mean) * torch.exp(-log_scale), torch.sum(log_scale, dim=-1)


class ConditionalSplineAutoregressive(nn.Module):
    """Autoregressive linear-rational spline transform ('spline_masked')."""

    def __init__(self, input_dim: int, context_dim: int, hidden_dims: Sequence[int], num_parts: int,
                 count_bins: int = 8, bound: float = 3.0):
        super().__init__()
        self.input_dim = input_dim
        self.count_bins = count_bins
        self.bound = bound
        self.made = MADE(input_dim, context_dim, hidden_dims, 4 * count_bins - 1, num_parts)

    def reset_parameters(self, generator: torch.Generator):
        self.made.reset_parameters(generator)

    def _spline_params(self, x, context, parts):
        k = self.count_bins
        out = self.made(x, context, parts)
        return out[..., :k], out[..., k:2 * k], out[..., 2 * k:3 * k - 1], out[..., 3 * k - 1:]

    def forward(self, x, context, parts):
        y = torch.zeros_like(x)
        for d in range(self.input_dim):
            out = monotonic_rational_spline_forward(x, *self._spline_params(y, context, parts), bound=self.bound)
            y = torch.cat([y[..., :d], out[..., d:d + 1], y[..., d + 1:]], dim=-1)
        return y

    def inverse(self, y, context, parts):
        x, ld_inv = monotonic_rational_spline_inverse(y, *self._spline_params(y, context, parts), bound=self.bound)
        return x, -torch.sum(ld_inv, dim=-1)


class FlowBatchNorm(nn.Module):
    """BatchNorm flow layer: the density direction normalises with the
    running statistics, the sampling direction undoes it.  Parameters per
    part: log_gamma, beta, moving_mean, moving_var (num_parts, D)."""

    def __init__(self, input_dim: int, num_parts: int, momentum: float = 0.1, epsilon: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.epsilon = epsilon
        self.log_gamma = nn.Parameter(torch.zeros(num_parts, input_dim))
        self.beta = nn.Parameter(torch.zeros(num_parts, input_dim))
        self.moving_mean = nn.Parameter(torch.zeros(num_parts, input_dim))
        self.moving_var = nn.Parameter(torch.ones(num_parts, input_dim))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator = None):
        self.log_gamma.zero_()
        self.beta.zero_()
        self.moving_mean.zero_()
        self.moving_var.fill_(1.0)

    def forward(self, x, context=None, parts=None):
        std = torch.sqrt(self.moving_var[parts] + self.epsilon)
        return (x - self.beta[parts]) * torch.exp(-self.log_gamma[parts]) * std + self.moving_mean[parts]

    def inverse(self, y, context=None, parts=None):
        std = torch.sqrt(self.moving_var[parts] + self.epsilon)
        x = (y - self.moving_mean[parts]) / std * torch.exp(self.log_gamma[parts]) + self.beta[parts]
        ld = torch.sum(torch.log(std) - self.log_gamma[parts], dim=-1)
        return x, ld.expand(y.shape[:-1])

    group = None  # a process group: the batch statistics are the whole batch's over its ranks

    @torch.no_grad()
    def update_stats(self, y):
        """The training-mode inverse of every part: moves the running
        statistics towards the batch's (mean, unbiased variance over every
        leading axis of y (..., num_parts, D)) in place, and returns y
        normalised with the batch statistics.  With `group`, the statistics
        are those of the whole batch over the group's ranks (equal blocks):
        the unbiased divisor is the global count less one."""
        axes = tuple(range(y.dim() - 2))
        if self.group is None:
            mean = torch.mean(y, dim=axes)
            var = torch.var(y, dim=axes, correction=1)
        else:
            from ..parallel.mesh import all_reduce_sum

            count = y[..., 0, 0].numel() * torch.distributed.get_world_size(self.group)
            mean = all_reduce_sum(y.sum(dim=axes), self.group) / count
            var = all_reduce_sum(((y - mean) ** 2).sum(dim=axes), self.group) / (count - 1)
        m = self.momentum
        self.moving_mean.copy_((1.0 - m) * self.moving_mean + m * mean)
        self.moving_var.copy_((1.0 - m) * self.moving_var + m * var)
        return (y - mean) / torch.sqrt(var + self.epsilon) * torch.exp(self.log_gamma) + self.beta
