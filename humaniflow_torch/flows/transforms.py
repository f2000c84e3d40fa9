"""Flow transforms: the forward (base → data) and inverse directions.

The PyTorch counterpart of `humaniflow_tpu/flows/transforms.py`:
permutation, the conditional spline, additive and affine couplings, the
conditional and unconditional linear PLU layers, and the scaled and the
unscaled radial tanh.  Each module's
`forward(x, context, parts)` returns y without a log-det (the sampling path
does not use it); `inverse(y, context, parts)` returns (x, log|dy/dx| at x),
reduced over the event dim, as the JAX transforms' `inverse` does (the
unscaled RadialTanh, on no path of the model, returns the log-det both ways,
as JAX's does).  `parts`
selects the per-part weights of the part-stacked hypernets (see
dense_nn.py) and of the other per-part parameters.  A transform with
parameters has `reset_parameters(generator)`.
"""

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
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

    def reset_parameters(self, generator: torch.Generator):
        self.hypernet.reset_parameters(generator)

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


class _Coupling(nn.Module):
    """A coupling whose hypernet over concat([context, x_lower]) emits
    `num_params` vectors for the upper input_dim − split_dim dims."""

    def __init__(self, input_dim: int, context_dim: int, hidden_dims: Sequence[int], num_parts: int,
                 num_params: int, split_dim: Optional[int] = None):
        super().__init__()
        self.split = input_dim // 2 if split_dim is None else split_dim
        u = input_dim - self.split
        self.hypernet = DenseNN(self.split, context_dim, hidden_dims, (u,) * num_params, num_parts)

    def reset_parameters(self, generator: torch.Generator):
        self.hypernet.reset_parameters(generator)


class ConditionalAdditiveCoupling(_Coupling):
    """NICE-style volume-preserving coupling: y2 = x2 + mean(context, x1)."""

    def __init__(self, input_dim: int, context_dim: int, hidden_dims: Sequence[int], num_parts: int,
                 split_dim: Optional[int] = None):
        super().__init__(input_dim, context_dim, hidden_dims, num_parts, 1, split_dim)

    def forward(self, x, context, parts):
        s = self.split
        (mean,) = self.hypernet(x[..., :s], context, parts)
        return torch.cat([x[..., :s], x[..., s:] + mean], dim=-1)

    def inverse(self, y, context, parts):
        s = self.split
        (mean,) = self.hypernet(y[..., :s], context, parts)
        return torch.cat([y[..., :s], y[..., s:] - mean], dim=-1), y.new_zeros(y.shape[:-1])


class ConditionalAffineCoupling(_Coupling):
    """RealNVP-style affine coupling: y2 = mean + exp(log_scale)·x2, the
    log-scale clamped to [min, max] on the forward pass with the gradient of
    the identity (pyro's clamp_preserve_gradients)."""

    def __init__(self, input_dim: int, context_dim: int, hidden_dims: Sequence[int], num_parts: int,
                 split_dim: Optional[int] = None, log_scale_min_clip: float = -5.0,
                 log_scale_max_clip: float = 3.0):
        super().__init__(input_dim, context_dim, hidden_dims, num_parts, 2, split_dim)
        self.log_scale_min_clip = log_scale_min_clip
        self.log_scale_max_clip = log_scale_max_clip

    def _params(self, x1, context, parts):
        mean, log_scale = self.hypernet(x1, context, parts)
        clamped = torch.clamp(log_scale, self.log_scale_min_clip, self.log_scale_max_clip)
        return mean, log_scale + (clamped - log_scale).detach()

    def forward(self, x, context, parts):
        s = self.split
        mean, log_scale = self._params(x[..., :s], context, parts)
        return torch.cat([x[..., :s], mean + torch.exp(log_scale) * x[..., s:]], dim=-1)

    def inverse(self, y, context, parts):
        s = self.split
        mean, log_scale = self._params(y[..., :s], context, parts)
        x = torch.cat([y[..., :s], (y[..., s:] - mean) * torch.exp(-log_scale)], dim=-1)
        return x, torch.sum(log_scale, dim=-1)


def _permutation_matrix(input_dim: int, permutation: Tuple[int, ...]) -> torch.Tensor:
    return torch.eye(input_dim)[list(permutation or range(input_dim))]


def _plu_forward(perm, l_mat, u_mat, x):
    """y = P·L·U·x, the matrices broadcast against x's leading dims."""
    return torch.einsum("ij,...jk,...kl,...l->...i", perm, l_mat, u_mat, x)


def _plu_inverse(perm, l_mat, u_mat, y):
    """x with P·L·U·x = y: L·U·x = Pᵀ·y by two triangular solves."""
    rhs = torch.einsum("ji,...j->...i", perm, y)[..., None]
    ux = torch.linalg.solve_triangular(l_mat, rhs, upper=False)
    return torch.linalg.solve_triangular(u_mat, ux, upper=True)[..., 0]


class ConditionalLinearPLU(nn.Module):
    """Invertible linear layer W = P·L·U whose L and U a context-only
    hypernet predicts; U's diagonal is made positive by softplus(β = 0.75)."""

    def __init__(self, input_dim: int, context_dim: int, hidden_dims: Sequence[int], num_parts: int,
                 permutation: Tuple[int, ...] = (), softplus_beta: float = 0.75):
        super().__init__()
        self.input_dim = input_dim
        self.softplus_beta = softplus_beta
        self.hypernet = DenseNN(0, context_dim, hidden_dims, (input_dim * input_dim,), num_parts)
        self.register_buffer("perm", _permutation_matrix(input_dim, permutation), persistent=False)

    def reset_parameters(self, generator: torch.Generator):
        self.hypernet.reset_parameters(generator)

    def _lu(self, context, parts):
        d = self.input_dim
        (raw,) = self.hypernet(None, context, parts)
        lu = raw.reshape(raw.shape[:-1] + (d, d))
        u_diag = F.softplus(self.softplus_beta * torch.diagonal(lu, dim1=-2, dim2=-1)) / self.softplus_beta
        eye = torch.eye(d, dtype=lu.dtype, device=lu.device)
        l_mat = torch.tril(lu, diagonal=-1) + eye
        u_mat = torch.triu(lu, diagonal=1) + torch.diag_embed(u_diag)
        return l_mat, u_mat, u_diag

    def forward(self, x, context, parts):
        l_mat, u_mat, _ = self._lu(context, parts)
        return _plu_forward(self.perm, l_mat, u_mat, x)

    def inverse(self, y, context, parts):
        l_mat, u_mat, u_diag = self._lu(context, parts)
        ld = torch.sum(torch.log(torch.abs(u_diag)), dim=-1)
        return _plu_inverse(self.perm, l_mat, u_mat, y), ld.expand(y.shape[:-1])


class LinearPLU(nn.Module):
    """Unconditional invertible linear layer W = P·L·U, one packed LU matrix
    per part (unit L diagonal implied), initialised from the LU factors of a
    random orthogonal matrix."""

    def __init__(self, input_dim: int, num_parts: int, permutation: Tuple[int, ...] = ()):
        super().__init__()
        self.input_dim = input_dim
        self.LU = nn.Parameter(torch.empty(num_parts, input_dim, input_dim))
        self.register_buffer("perm", _permutation_matrix(input_dim, permutation), persistent=False)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator):
        d = self.input_dim
        perm = self.perm.cpu()
        for part in range(self.LU.shape[0]):
            w = torch.linalg.qr(torch.randn(d, d, generator=generator))[0]
            _, l_mat, u_mat = torch.linalg.lu(perm.T @ w)
            self.LU[part] = (torch.tril(l_mat, diagonal=-1) + torch.triu(u_mat)).to(self.LU.device)

    def _lu(self, parts):
        lu = self.LU[parts]  # (P, D, D)
        u_diag = torch.diagonal(lu, dim1=-2, dim2=-1)
        l_mat = torch.tril(lu, diagonal=-1) + torch.eye(self.input_dim, dtype=lu.dtype, device=lu.device)
        u_mat = torch.triu(lu, diagonal=1) + torch.diag_embed(u_diag)
        return l_mat, u_mat, u_diag

    def forward(self, x, context=None, parts=None):
        l_mat, u_mat, _ = self._lu(parts)
        return _plu_forward(self.perm, l_mat, u_mat, x)

    def inverse(self, y, context=None, parts=None):
        l_mat, u_mat, u_diag = self._lu(parts)
        ld = torch.sum(torch.log(torch.abs(u_diag)), dim=-1)  # (P,)
        return _plu_inverse(self.perm, l_mat, u_mat, y), ld.expand(y.shape[:-1])


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


class RadialTanh(nn.Module):
    """Unscaled radial compactification y = (x/‖x‖)·R·tanh(‖x‖) with the
    corrected log-det (the reference documents the original ReLie log-det
    as wrong and fixes it).  `forward` returns (y, log|dy/dx| at x) and
    `inverse` (x, log|dy/dx| at x), as the JAX transform's do."""

    def __init__(self, radius: float):
        super().__init__()
        self.radius = radius

    def _log_det(self, scale, tanh_sq):
        # log|det dy/dx| = log R + log(1 - tanh²) + 2 log(g(‖x‖)/‖x‖); the
        # scale g(‖x‖)/‖x‖ → R as ‖x‖ → 0, so the limit is 3 log R
        return math.log(self.radius) + torch.log1p(-tanh_sq) + 2.0 * torch.log(torch.clamp(scale, min=1e-30))

    def forward(self, x, context=None, parts=None):
        r = self.radius
        norm_sq = torch.sum(x * x, dim=-1, keepdim=True)
        small = norm_sq < 1e-16
        norm = torch.sqrt(torch.where(small, torch.ones_like(norm_sq), norm_sq))
        scale = torch.where(small, torch.full_like(norm, r), torch.tanh(norm) * r / norm)
        y = x * scale
        tanh_sq = torch.clamp(torch.sum(y * y, dim=-1) / (r * r), 0.0, 1.0 - 1e-7)
        return y, self._log_det(scale[..., 0], tanh_sq)

    def inverse(self, y, context=None, parts=None):
        r = self.radius
        norm_sq = torch.sum(y * y, dim=-1, keepdim=True)
        small = norm_sq < 1e-16
        norm = torch.sqrt(torch.where(small, torch.ones_like(norm_sq), norm_sq))
        ratio = torch.clamp(norm / r, 0.0, 1.0 - 1e-6)
        inv_scale = torch.where(small, torch.full_like(norm, 1.0 / r), torch.atanh(ratio) / norm)
        tanh_sq = torch.clamp(ratio[..., 0] ** 2, 0.0, 1.0 - 1e-7)
        fwd_scale = torch.where(small[..., 0], torch.full_like(tanh_sq, r), 1.0 / inv_scale[..., 0])
        return y * inv_scale, self._log_det(fwd_scale, tanh_sq)
