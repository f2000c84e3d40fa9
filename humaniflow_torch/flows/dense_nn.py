"""Part-stacked hypernetwork MLPs for conditional flow transforms.

The PyTorch counterpart of `humaniflow_tpu/flows/dense_nn.py` (pyro's
`ConditionalDenseNN`): a ReLU MLP over concat([context, x]), context first,
whose last layer is split into the requested param_dims.  With input_dim 0
it reads the context alone (pyro's `DenseNN`), as the conditional linear
PLU's hypernet does.  Each of the
`num_parts` body parts has its own weights, stacked on a leading axis, so
one batched matmul evaluates every part of a kinematic depth level.
"""

from typing import Sequence

import torch
from torch import nn


class DenseNN(nn.Module):
    """weights[i]: (num_parts, out, in); biases[i]: (num_parts, out)."""

    def __init__(
        self,
        input_dim: int,
        context_dim: int,
        hidden_dims: Sequence[int],
        param_dims: Sequence[int],
        num_parts: int,
    ):
        super().__init__()
        self.param_dims = tuple(param_dims)
        dims = [input_dim + context_dim] + list(hidden_dims) + [sum(param_dims)]
        self.weights = nn.ParameterList(
            nn.Parameter(torch.empty(num_parts, dims[i + 1], dims[i]))
            for i in range(len(dims) - 1)
        )
        self.biases = nn.ParameterList(
            nn.Parameter(torch.empty(num_parts, dims[i + 1])) for i in range(len(dims) - 1)
        )

    def reset_parameters(self, generator: torch.Generator):
        """torch.nn.Linear's default: U(±1/√fan_in) for weight and bias."""
        for w, b in zip(self.weights, self.biases):
            bound = 1.0 / w.shape[-1] ** 0.5
            w.data.uniform_(-bound, bound, generator=generator)
            b.data.uniform_(-bound, bound, generator=generator)

    def forward(self, x, context, parts):
        """:param x: (..., P, input_dim), or None for a context-only net.
        :param context: (..., P, context_dim).
        :param parts: LongTensor (P,) of the part indices on the P axis.
        :return: tuple of (..., P, d) per param_dims."""
        if x is None:
            h = context
        else:
            h = torch.cat([context.expand(x.shape[:-1] + context.shape[-1:]), x], dim=-1)
        n_layers = len(self.weights)
        for i in range(n_layers):
            w = self.weights[i][parts]  # (P, out, in)
            h = torch.einsum("...pi,poi->...po", h, w) + self.biases[i][parts]
            if i < n_layers - 1:
                h = torch.relu(h)
        return tuple(torch.split(h, self.param_dims, dim=-1))
