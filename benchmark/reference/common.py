"""Precision control and the rotation formulas the reference shares."""

import contextlib

import torch
import torch.nn.functional as F

PRECISIONS = ("float32", "tf32")


@contextlib.contextmanager
def precision(name: str):
    """Run matmuls and cuDNN convolutions in full float32 ("float32") or in
    TF32 ("tf32"), restoring the caller's settings after.  On the CPU the
    convolutions run without oneDNN, whose float32 training gradients are
    far from exact."""
    if name not in PRECISIONS:
        raise ValueError(f"precision {name!r} not in {PRECISIONS}")
    tf32 = name == "tf32"
    cudnn = torch.backends.cudnn
    matmul = torch.backends.cuda.matmul
    before = matmul.allow_tf32
    matmul.allow_tf32 = tf32
    try:
        with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                         deterministic=cudnn.deterministic, allow_tf32=tf32), torch.backends.mkldnn.flags(enabled=False):
            yield
    finally:
        matmul.allow_tf32 = before


def bn_eval(x, w, name: str, eps: float = 1e-5):
    """Eval-mode BatchNorm on NCHW x with the weights w[f"{name}.*"]."""
    return F.batch_norm(x, w[f"{name}.running_mean"], w[f"{name}.running_var"], w[f"{name}.weight"],
                        w[f"{name}.bias"], False, 0.0, eps)


def bn_batch(x, w, name: str, eps: float = 1e-5):
    """Train-mode BatchNorm on NCHW x: the batch's statistics (biased
    variance), the running ones left alone."""
    return F.batch_norm(x, None, None, w[f"{name}.weight"], w[f"{name}.bias"], True, 0.0, eps)


def _sinc_from_sq(theta_sq):
    eps = 1e-4
    small = theta_sq < eps * eps
    safe = torch.sqrt(torch.where(small, torch.ones_like(theta_sq), theta_sq))
    return torch.where(small, 1.0 - theta_sq / 6.0, torch.sin(safe) / safe)


def so3_hat(v):
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack([torch.stack([zero, -z, y], -1), torch.stack([z, zero, -x], -1),
                        torch.stack([-y, x, zero], -1)], dim=-2)


def so3_exp(v):
    """Rodrigues: R = I + sinc(θ)·K + ½·sinc(θ/2)²·K²."""
    theta_sq = torch.sum(v * v, dim=-1)
    alpha = _sinc_from_sq(theta_sq)
    half = _sinc_from_sq(theta_sq * 0.25)
    beta = 0.5 * half * half
    k = so3_hat(v)
    eye = torch.eye(3, dtype=v.dtype, device=v.device)
    return eye + alpha[..., None, None] * k + beta[..., None, None] * torch.matmul(k, k)


def rot6d_to_rotmat(x):
    """6D representation [R11, R12, R21, R22, R31, R32] → (..., 3, 3)."""
    m = x.reshape(x.shape[:-1] + (3, 2))
    a1, a2 = m[..., 0], m[..., 1]
    b1 = a1 / torch.clamp(torch.linalg.norm(a1, dim=-1, keepdim=True), min=1e-12)
    u2 = a2 - torch.sum(b1 * a2, dim=-1, keepdim=True) * b1
    b2 = u2 / torch.clamp(torch.linalg.norm(u2, dim=-1, keepdim=True), min=1e-12)
    return torch.stack([b1, b2, torch.linalg.cross(b1, b2, dim=-1)], dim=-1)
