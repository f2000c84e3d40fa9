"""Monotonic linear-rational spline (LRS) bijection: the forward direction
(sampling), the inverse with its log-det (density), and the JAX package's
one-call form with the log-det both ways.

The PyTorch counterpart of `humaniflow_tpu/flows/spline.py` (pyro 1.7's
`_monotonic_rational_spline` with order='linear').  The JAX package selects
each element's bin with a one-hot contraction; here the bin index is the
same count of knots at or below x (so a tie at a knot goes to the bin the
knot opens, as in JAX) and the bin parameters are read with `gather`.
"""

import torch
import torch.nn.functional as F

MIN_BIN_WIDTH = 1e-3
MIN_BIN_HEIGHT = 1e-3
MIN_DERIVATIVE = 1e-3
MIN_LAMBDA = 0.025
EPS = 1e-6

# pyro pads the boundary-knot derivatives with the constant 1 - min_derivative.
_BOUNDARY_DERIV = 1.0 - MIN_DERIVATIVE


def _make_knots(unnormalized, bound, min_frac):
    """softmax-normalised bin sizes → (bin_sizes, cumulative knots (..., K+1))
    spanning [-bound, bound] exactly."""
    num_bins = unnormalized.shape[-1]
    sizes = torch.softmax(unnormalized, dim=-1)
    sizes = min_frac + (1.0 - min_frac * num_bins) * sizes
    cum = torch.cumsum(sizes, dim=-1)
    cum = F.pad(cum, (1, 0))
    cum = 2.0 * bound * cum - bound
    cum = torch.cat(
        [torch.full_like(cum[..., :1], -bound), cum[..., 1:-1], torch.full_like(cum[..., :1], bound)],
        dim=-1,
    )
    return cum[..., 1:] - cum[..., :-1], cum


def _search_bins(knots, x):
    """(..., 1) index of the bin holding each x, clamped to the valid range."""
    idx = torch.sum(x[..., None] >= (knots + EPS), dim=-1, keepdim=True) - 1
    return torch.clamp(idx, 0, knots.shape[-1] - 2)


def _gather(params, idx):
    return torch.gather(params, -1, idx)[..., 0]


def _bin_parameters(inputs, w_unnorm, h_unnorm, d_unnorm, l_unnorm, bound, inverse):
    """The parameters of the bin holding each input, searched among the
    width knots forward and the height knots inverse: (inside, clamped
    input, bin width, left knot x, lambda, wa, wb, wc, ya, yb, yc)."""
    inside = (inputs >= -bound) & (inputs <= bound)
    v = torch.clamp(inputs, -bound, bound)

    widths, cumwidths = _make_knots(w_unnorm, bound, MIN_BIN_WIDTH)
    heights, cumheights = _make_knots(h_unnorm, bound, MIN_BIN_HEIGHT)

    pad = torch.full_like(d_unnorm[..., :1], _BOUNDARY_DERIV)
    interior = MIN_DERIVATIVE + F.softplus(d_unnorm)
    derivatives = torch.cat([pad, interior, pad], dim=-1)  # (..., K+1)

    lambdas = (1.0 - 2.0 * MIN_LAMBDA) * torch.sigmoid(l_unnorm) + MIN_LAMBDA

    idx = _search_bins(cumheights if inverse else cumwidths, v)
    in_w = _gather(widths, idx)
    in_cw = _gather(cumwidths[..., :-1], idx)
    in_ch = _gather(cumheights[..., :-1], idx)
    in_h = _gather(heights, idx)
    in_delta = _gather(heights / widths, idx)
    in_d = _gather(derivatives[..., :-1], idx)
    in_d1 = _gather(derivatives[..., 1:], idx)
    lam = _gather(lambdas, idx)

    # LRS weights: wa at the left knot (set to 1), wb at the right knot, wc
    # at the interior division point.
    wa = torch.ones_like(in_d)
    wb = torch.sqrt(in_d / in_d1) * wa
    wc = (lam * wa * in_d + (1.0 - lam) * wb * in_d1) / in_delta
    ya = in_ch
    yb = in_h + in_ch
    yc = ((1.0 - lam) * wa * ya + lam * wb * yb) / ((1.0 - lam) * wa + lam * wb)
    return inside, v, in_w, in_cw, lam, wa, wb, wc, ya, yb, yc


def monotonic_rational_spline_forward(inputs, w_unnorm, h_unnorm, d_unnorm, l_unnorm, bound: float = 3.0):
    """Elementwise monotonic linear-rational spline, x → y (no log-det: the
    sampling path does not use it).

    :param inputs: (..., D)
    :param w_unnorm/h_unnorm/l_unnorm: (..., D, K) unnormalised widths,
        heights and lambdas; :param d_unnorm: (..., D, K-1) interior
        derivatives.
    :return: outputs (..., D); the identity outside [-bound, bound].
    """
    return _spline_forward(inputs, w_unnorm, h_unnorm, d_unnorm, l_unnorm, bound, with_logdet=False)


def _spline_forward(inputs, w_unnorm, h_unnorm, d_unnorm, l_unnorm, bound, with_logdet):
    inside, x, in_w, in_cw, lam, wa, wb, wc, ya, yb, yc = _bin_parameters(
        inputs, w_unnorm, h_unnorm, d_unnorm, l_unnorm, bound, inverse=False
    )
    theta = (x - in_cw) / in_w
    lo = theta <= lam
    numerator = torch.where(
        lo,
        wa * ya * (lam - theta) + wc * yc * theta,
        wc * yc * (1.0 - theta) + wb * yb * (theta - lam),
    )
    denominator = torch.where(
        lo,
        wa * (lam - theta) + wc * theta,
        wc * (1.0 - theta) + wb * (theta - lam),
    )
    outputs = torch.where(inside, numerator / denominator, inputs)
    if not with_logdet:
        return outputs
    deriv_num = torch.where(lo, wa * wc * lam * (yc - ya), wb * wc * (1.0 - lam) * (yb - yc)) * in_w
    # dy/dx = deriv_num / (denominator² · width²)
    logabsdet = (
        torch.log(torch.clamp(deriv_num, min=1e-38))
        - 2.0 * torch.log(torch.clamp(torch.abs(denominator), min=1e-38))
        - 2.0 * torch.log(in_w)
    )
    return outputs, torch.where(inside, logabsdet, torch.zeros_like(logabsdet))


def monotonic_rational_spline(inputs, w_unnorm, h_unnorm, d_unnorm, l_unnorm, inverse: bool = False,
                              bound: float = 3.0):
    """The JAX package's one-call form of the spline: (outputs, logabsdet),
    log|dy/dx| forward and log|dx/dy| with inverse=True (pyro's convention:
    the caller negates it for the inverse direction).  Arguments as
    monotonic_rational_spline_forward."""
    if inverse:
        return monotonic_rational_spline_inverse(inputs, w_unnorm, h_unnorm, d_unnorm, l_unnorm, bound)
    return _spline_forward(inputs, w_unnorm, h_unnorm, d_unnorm, l_unnorm, bound, with_logdet=True)


def monotonic_rational_spline_inverse(inputs, w_unnorm, h_unnorm, d_unnorm, l_unnorm, bound: float = 3.0):
    """Inverse of the spline, y → x, with log|dx/dy| (the JAX package's
    `monotonic_rational_spline(..., inverse=True)`; the caller negates it
    for the forward log-det).  Arguments as monotonic_rational_spline_forward.

    :return: (outputs (..., D), logabsdet (..., D)); the identity with zero
        log-det outside [-bound, bound].
    """
    inside, y, in_w, in_cw, lam, wa, wb, wc, ya, yb, yc = _bin_parameters(
        inputs, w_unnorm, h_unnorm, d_unnorm, l_unnorm, bound, inverse=True
    )
    lo = y <= yc
    numerator = torch.where(lo, lam * wa * (ya - y), (wc - lam * wb) * y + lam * wb * yb - wc * yc)
    denominator = torch.where(lo, (wc - wa) * y + wa * ya - wc * yc, (wc - wb) * y + wb * yb - wc * yc)
    outputs = numerator / denominator * in_w + in_cw
    deriv_num = torch.where(lo, wa * wc * lam * (yc - ya), wb * wc * (1.0 - lam) * (yb - yc)) * in_w
    logabsdet = torch.log(torch.clamp(deriv_num, min=1e-38)) - 2.0 * torch.log(
        torch.clamp(torch.abs(denominator), min=1e-38)
    )
    return torch.where(inside, outputs, inputs), torch.where(inside, logabsdet, torch.zeros_like(logabsdet))
