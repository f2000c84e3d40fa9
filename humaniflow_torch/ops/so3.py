"""SO(3) Lie-group operations in float32-safe form.

The PyTorch counterpart of `humaniflow_tpu/ops/so3.py`.  The formulas are
the cancellation-free ones (``(1-cos θ)/θ² = ½·sinc(θ/2)²``) with the same
small-angle and θ≈π epsilons, so that float32 results match the JAX package
element for element.  All ops broadcast over leading batch dims.
"""

import math

import torch

# All 8 combinations of (±1, ±1, ±1), in the JAX package's order.
_SIGNS = [[2 * ((i >> (2 - j)) & 1) - 1 for j in range(3)] for i in range(8)]


def _small_angle_eps(dtype) -> float:
    """Threshold below which Taylor expansions replace trig ratios."""
    return 1e-10 if dtype == torch.float64 else 1e-4


def _pi_branch_eps(dtype) -> float:
    """Width of the θ≈π window where the main log-map branch is replaced
    (wider in float32: the main branch's error grows like 1/(π−θ))."""
    return 1e-2 if dtype == torch.float64 else 1e-1


def sinc(theta: torch.Tensor) -> torch.Tensor:
    """sin(θ)/θ with a Taylor guard at θ≈0 (unnormalised sinc)."""
    small = theta.abs() < _small_angle_eps(theta.dtype)
    safe = torch.where(small, torch.ones_like(theta), theta)
    return torch.where(small, 1.0 - theta * theta / 6.0, torch.sin(safe) / safe)


def _sinc_from_sq(theta_sq: torch.Tensor) -> torch.Tensor:
    """sin(√t)/√t as a function of t=θ² (polynomial Taylor branch at t≈0)."""
    eps = _small_angle_eps(theta_sq.dtype)
    small = theta_sq < eps * eps
    safe = torch.sqrt(torch.where(small, torch.ones_like(theta_sq), theta_sq))
    return torch.where(small, 1.0 - theta_sq / 6.0, torch.sin(safe) / safe)


def so3_hat(v: torch.Tensor) -> torch.Tensor:
    """R³ → so(3): 3-vectors to skew-symmetric matrices."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


def so3_vee(m: torch.Tensor) -> torch.Tensor:
    """so(3) → R³: skew-symmetric matrices to 3-vectors."""
    return torch.stack([-m[..., 1, 2], m[..., 0, 2], -m[..., 0, 1]], dim=-1)


def batch_trace(m: torch.Tensor) -> torch.Tensor:
    return m.diagonal(dim1=-2, dim2=-1).sum(-1)


def so3_exp(v: torch.Tensor) -> torch.Tensor:
    """Exponential map so(3) → SO(3) (Rodrigues):
    α = sinc(θ), β = ½·sinc(θ/2)², R = I + α·K + β·K²."""
    theta_sq = torch.sum(v * v, dim=-1)
    alpha = _sinc_from_sq(theta_sq)
    half_sinc = _sinc_from_sq(theta_sq * 0.25)
    beta = 0.5 * half_sinc * half_sinc
    k = so3_hat(v)
    k2 = torch.matmul(k, k)
    eye = torch.eye(3, dtype=v.dtype, device=v.device)
    return eye + alpha[..., None, None] * k + beta[..., None, None] * k2


def _so3_log_pi(r: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """θ≈π branch of the log map: axis magnitudes from the symmetric part,
    then the sign combination minimising ‖R − exp(x)‖² (selection carries
    no gradient)."""
    sym = 0.5 * (r + r.transpose(-1, -2))
    eye = torch.eye(3, dtype=r.dtype, device=r.device)
    denom = torch.clamp(1.0 - torch.cos(theta), min=1e-6)
    z = (theta * theta / denom)[..., None, None] * (sym - eye)
    q = torch.stack([z[..., 0, 0], z[..., 1, 1], z[..., 2, 2]], dim=-1)
    mix = torch.stack(
        [
            q[..., 0] - q[..., 1] - q[..., 2],
            -q[..., 0] + q[..., 1] - q[..., 2],
            -q[..., 0] - q[..., 1] + q[..., 2],
        ],
        dim=-1,
    )
    x_abs = torch.sqrt(torch.clamp(mix, min=1e-8) * 0.5)
    signs = torch.tensor(_SIGNS, dtype=r.dtype, device=r.device)  # (8, 3)
    cands = signs * x_abs[..., None, :]  # (..., 8, 3)
    r_cands = so3_exp(cands)
    diff = torch.sum((r[..., None, :, :] - r_cands) ** 2, dim=(-1, -2))
    sel = torch.argmin(diff.detach(), dim=-1)
    idx = sel[..., None, None].expand(sel.shape + (1, 3))
    return torch.gather(cands, -2, idx).squeeze(-2)


def so3_log(r: torch.Tensor) -> torch.Tensor:
    """Logarithm map SO(3) → so(3) as axis-angle 3-vectors.

    Main branch (θ/sin θ)·vee(antisym(R)), a Taylor guard at θ≈0 and the
    candidate-search branch at θ≈π.  θ is straight-through: the value uses
    the exact clip of cos θ to [-1, 1], the gradient a strictly interior one.
    """
    dtype = r.dtype
    anti = 0.5 * (r - r.transpose(-1, -2))
    tiny = 1e-7 if dtype == torch.float64 else 1e-6
    c = 0.5 * (batch_trace(r) - 1.0)
    theta_val = torch.arccos(torch.clamp(c, -1.0, 1.0))
    theta_grad = torch.arccos(torch.clamp(c, -1.0 + tiny, 1.0 - tiny))
    theta = theta_grad + (theta_val - theta_grad).detach()

    near_pi = (math.pi - theta) < _pi_branch_eps(dtype)
    small = theta < _small_angle_eps(dtype)
    sin_theta = torch.sin(theta)
    safe_sin = torch.where(small | near_pi, torch.ones_like(sin_theta), sin_theta)
    ratio = torch.where(small, 1.0 + theta * theta / 6.0, theta / safe_sin)
    main = ratio[..., None] * so3_vee(anti)
    return torch.where(near_pi[..., None], _so3_log_pi(r, theta), main)


def so3_xset(x: torch.Tensor, k_max: int = 1) -> torch.Tensor:
    """Algebra elements with the same image under exp, excluding x:
    x/‖x‖·(‖x‖ + 2πk) for k ∈ {-k_max..-1, 1..k_max}, shape (2·k_max, ..., 3).
    A zero-norm x is shifted along a fixed axis."""
    norm = torch.linalg.norm(x, dim=-1, keepdim=True)
    tiny = norm < 1e-12
    safe_norm = torch.where(tiny, torch.ones_like(norm), norm)
    axis = torch.tensor([1.0, 0.0, 0.0], dtype=x.dtype, device=x.device)
    unit = torch.where(tiny, axis, x / safe_norm)
    ar = torch.arange(1, k_max + 1, dtype=x.dtype, device=x.device)
    ks = torch.cat([-ar, ar]).reshape((2 * k_max,) + (1,) * x.dim())
    norm0 = torch.where(tiny, torch.zeros_like(norm), norm)
    return unit[None] * (norm0[None] + 2.0 * math.pi * ks)


def so3_log_abs_det_jacobian(x: torch.Tensor) -> torch.Tensor:
    """log|det J| of the exp map at x: log(sinc(‖x‖/2)²)."""
    theta_sq = torch.sum(x * x, dim=-1)
    s = _sinc_from_sq(theta_sq * 0.25)
    return 2.0 * torch.log(torch.clamp(s.abs(), min=1e-30))
