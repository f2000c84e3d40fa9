"""HuManiFlow's training step, plain: the forward with the encoder's
BatchNorm on the batch's statistics, the (B, N+1) pass whose samples carry
shape noise, the teacher-forced flow contexts and the SO(3) log-density of
the target rotations, the joints' 2D projections, the loss, autograd's
gradients and one Adam update (torch.optim.Adam's defaults as optax.adam's:
β = (0.9, 0.999), ε = 1e-8; every parameter updated, a missing gradient as
zero; the step skipped when the loss or the gradient's norm is not finite).
"""

import math

import torch

from .common import so3_exp
from .humaniflow import autoregress, encoder, heads, isgc_features, part_contexts
from .humaniflow import _knots, MIN_BIN_HEIGHT, MIN_BIN_WIDTH, MIN_DERIVATIVE, MIN_LAMBDA, SPLINE_EPS
from .smpl import smpl_forward

COCO_FROM_SMPL90 = [24, 26, 25, 28, 27, 16, 17, 18, 19, 20, 21, 1, 2, 4, 5, 7, 8]
NEG_INF = -1e30
_SIGNS = [[2 * ((i >> (2 - j)) & 1) - 1 for j in range(3)] for i in range(8)]


# ------------------------------------------------------------- SO(3) maps
def so3_log(r):
    """Log map with a Taylor guard at θ≈0 and the candidate search at θ≈π;
    θ's value from the exact clip of cos θ, its gradient from an interior one."""
    anti = 0.5 * (r - r.transpose(-1, -2))
    c = 0.5 * (r.diagonal(dim1=-2, dim2=-1).sum(-1) - 1.0)
    theta_val = torch.arccos(torch.clamp(c, -1.0, 1.0))
    theta_grad = torch.arccos(torch.clamp(c, -1.0 + 1e-6, 1.0 - 1e-6))
    theta = theta_grad + (theta_val - theta_grad).detach()
    near_pi = (math.pi - theta) < 1e-1
    small = theta < 1e-4
    sin_t = torch.sin(theta)
    safe = torch.where(small | near_pi, torch.ones_like(sin_t), sin_t)
    ratio = torch.where(small, 1.0 + theta * theta / 6.0, theta / safe)
    vee = torch.stack([-anti[..., 1, 2], anti[..., 0, 2], -anti[..., 0, 1]], dim=-1)
    return torch.where(near_pi[..., None], _log_near_pi(r, theta), ratio[..., None] * vee)


def _log_near_pi(r, theta):
    sym = 0.5 * (r + r.transpose(-1, -2))
    eye = torch.eye(3, dtype=r.dtype, device=r.device)
    z = (theta * theta / torch.clamp(1.0 - torch.cos(theta), min=1e-6))[..., None, None] * (sym - eye)
    q0, q1, q2 = z[..., 0, 0], z[..., 1, 1], z[..., 2, 2]
    mix = torch.stack([q0 - q1 - q2, -q0 + q1 - q2, -q0 - q1 + q2], dim=-1)
    x_abs = torch.sqrt(torch.clamp(mix, min=1e-8) * 0.5)
    cands = torch.tensor(_SIGNS, dtype=r.dtype, device=r.device) * x_abs[..., None, :]
    diff = torch.sum((r[..., None, :, :] - so3_exp(cands)) ** 2, dim=(-1, -2))
    sel = torch.argmin(diff.detach(), dim=-1)
    return torch.gather(cands, -2, sel[..., None, None].expand(sel.shape + (1, 3))).squeeze(-2)


def _sinc_sq_half(theta_sq):
    t = theta_sq * 0.25
    small = t < 1e-8
    safe = torch.sqrt(torch.where(small, torch.ones_like(t), t))
    return torch.where(small, 1.0 - t / 6.0, torch.sin(safe) / safe)


def so3_log_abs_det_jacobian(x):
    return 2.0 * torch.log(torch.clamp(_sinc_sq_half(torch.sum(x * x, dim=-1)).abs(), min=1e-30))


def so3_xset(x):
    """The two other preimages x/‖x‖·(‖x‖ ± 2π), (2, ..., 3)."""
    norm = torch.linalg.norm(x, dim=-1, keepdim=True)
    tiny = norm < 1e-12
    unit = torch.where(tiny, torch.tensor([1.0, 0.0, 0.0], dtype=x.dtype, device=x.device),
                       x / torch.where(tiny, torch.ones_like(norm), norm))
    norm0 = torch.where(tiny, torch.zeros_like(norm), norm)
    ks = torch.tensor([-1.0, 1.0], dtype=x.dtype, device=x.device).reshape((2,) + (1,) * x.dim())
    return unit[None] * (norm0[None] + 2.0 * math.pi * ks)


# ------------------------------------------------------------ flow density
def spline_inverse(y, w_un, h_un, d_un, l_un, bound):
    """Inverse of the linear-rational spline, y → (x, log|dx/dy|)."""
    inside = (y >= -bound) & (y <= bound)
    v = torch.clamp(y, -bound, bound)
    widths, cumw = _knots(w_un, bound, MIN_BIN_WIDTH)
    heights, cumh = _knots(h_un, bound, MIN_BIN_HEIGHT)
    pad = torch.full_like(d_un[..., :1], 1.0 - MIN_DERIVATIVE)
    derivs = torch.cat([pad, MIN_DERIVATIVE + torch.nn.functional.softplus(d_un), pad], dim=-1)
    lambdas = (1.0 - 2.0 * MIN_LAMBDA) * torch.sigmoid(l_un) + MIN_LAMBDA
    idx = torch.clamp(torch.sum(v[..., None] >= (cumh + SPLINE_EPS), dim=-1, keepdim=True) - 1, 0, cumh.shape[-1] - 2)
    g = lambda t: torch.gather(t, -1, idx)[..., 0]  # noqa: E731
    in_w, in_cw, in_ch, in_h = g(widths), g(cumw[..., :-1]), g(cumh[..., :-1]), g(heights)
    delta, d0, d1, lam = g(heights / widths), g(derivs[..., :-1]), g(derivs[..., 1:]), g(lambdas)
    wa = torch.ones_like(d0)
    wb = torch.sqrt(d0 / d1) * wa
    wc = (lam * wa * d0 + (1.0 - lam) * wb * d1) / delta
    ya, yb = in_ch, in_h + in_ch
    yc = ((1.0 - lam) * wa * ya + lam * wb * yb) / ((1.0 - lam) * wa + lam * wb)
    lo = v <= yc
    num = torch.where(lo, lam * wa * (ya - v), (wc - lam * wb) * v + lam * wb * yb - wc * yc)
    den = torch.where(lo, (wc - wa) * v + wa * ya - wc * yc, (wc - wb) * v + wb * yb - wc * yc)
    x = num / den * in_w + in_cw
    dnum = torch.where(lo, wa * wc * lam * (yc - ya), wb * wc * (1.0 - lam) * (yb - yc)) * in_w
    ld = torch.log(torch.clamp(dnum, min=1e-38)) - 2.0 * torch.log(torch.clamp(torch.abs(den), min=1e-38))
    return torch.where(inside, x, y), torch.where(inside, ld, torch.zeros_like(ld))


def flow_log_prob(w, flow_cfg, y, ctx, parts):
    """log p(y | ctx) of points y (..., P, 3) under the flow: the inverse of
    the radial tanh and of each (permutation, spline coupling) block."""
    r, k = flow_cfg["COMPACT_SUPPORT_RADIUS"], flow_cfg["NUM_SPLINE_SEGMENTS"]
    norm_sq = torch.sum(y * y, dim=-1, keepdim=True)
    small = norm_sq < 1e-14
    norm = torch.sqrt(torch.where(small, torch.ones_like(norm_sq), norm_sq))
    ratio = torch.clamp(norm / r, 0.0, 1.0 - 1e-6)
    scale = torch.where(small, torch.ones_like(norm), torch.atanh(ratio) * r / norm)
    ratio_sq = torch.clamp(ratio[..., 0] ** 2, 0.0, 1.0 - 1e-7)
    total = torch.where(small[..., 0], torch.zeros_like(ratio_sq),
                        -2.0 * torch.log(torch.clamp(scale[..., 0], min=1e-30)) + torch.log1p(-ratio_sq))
    x = y * scale
    n_layers = len(flow_cfg["TRANSFORM_NN_HIDDEN_DIMS"]) + 1
    for i in reversed(range(flow_cfg["NUM_TRANSFORMS"])):
        t = 2 * i + 1
        h = torch.cat([ctx.expand(x.shape[:-1] + ctx.shape[-1:]), x[..., :1]], dim=-1)
        for layer in range(n_layers):
            wt = w[f"flow.transforms.{t}.hypernet.weights.{layer}"][parts]
            h = torch.einsum("...pi,poi->...po", h, wt) + w[f"flow.transforms.{t}.hypernet.biases.{layer}"][parts]
            if layer < n_layers - 1:
                h = torch.relu(h)
        sh = h.shape[:-1]
        wu, hu, du, lu = torch.split(h, (2 * k, 2 * k, 2 * (k - 1), 2 * k), dim=-1)
        x2, ld_inv = spline_inverse(x[..., 1:], wu.reshape(sh + (2, k)), hu.reshape(sh + (2, k)),
                                    du.reshape(sh + (2, k - 1)), lu.reshape(sh + (2, k)), r)
        x = torch.cat([x[..., :1], x2], dim=-1)
        total = total - torch.sum(ld_inv, dim=-1)
        s = i % 3
        perm = [(s + j) % 3 for j in range(3)]
        x = x[..., [perm.index(j) for j in range(3)]]
    var = flow_cfg["BASE_DIST_STD"] ** 2
    base = torch.sum(-0.5 * (x * x) / var - 0.5 * math.log(2 * math.pi * var), dim=-1)
    return base - total


def so3_log_prob(w, flow_cfg, rotmats, ctx, parts):
    """log p(R | ctx) over the three preimages of each rotation."""
    x = so3_log(rotmats)
    branches = torch.cat([x[None], so3_xset(x)], dim=0)
    inside = torch.linalg.norm(branches, dim=-1) < flow_cfg["COMPACT_SUPPORT_RADIUS"]
    safe = torch.where(inside[..., None], branches, torch.zeros_like(branches))
    lp = flow_log_prob(w, flow_cfg, safe, ctx[None].expand((3,) + ctx.shape), parts)
    terms = torch.where(inside, lp - so3_log_abs_det_jacobian(safe), torch.full_like(lp, NEG_INF))
    return torch.logsumexp(terms, dim=0)


# ------------------------------------------------------------------- step
def loss(w, smpl, cfg, batch, shape_noise, base_noise):
    """(total, {term: value}) of one batch: batch proxy (B, H, W, 18),
    pose_rotmats (B, 23, 3, 3), glob_rotmats (B, 3, 3), shape (B, nb),
    joints2D (B, 17, 2) pixels, joints2D_vis (B, 17)."""
    model_cfg, loss_cfg = cfg["MODEL"], cfg["LOSS"]
    flow_cfg = model_cfg["NORM_FLOW"]
    feats = encoder(w, batch["proxy"], model_cfg["NUM_RESNET_LAYERS"], train=True)
    cam, glob, mode, log_std = heads(w, model_cfg, feats)
    b = mode.shape[0]
    samples = mode[:, None] + shape_noise * torch.exp(log_std)[:, None]
    shape_all = torch.cat([mode[:, None], samples], dim=1)
    _, rot_all = autoregress(w, flow_cfg, isgc_features(w, feats, shape_all, glob, cam), base_noise)
    rot_pe = rot_all[:, 0].detach()

    isgc_ll = isgc_features(w, feats, batch["shape"][:, None], batch["glob_rotmats"], cam)[:, 0]
    all_parts = list(range(23))
    ctx = part_contexts(w, isgc_ll, batch["pose_rotmats"], all_parts)
    pose_lp = so3_log_prob(w, flow_cfg, batch["pose_rotmats"], ctx, torch.arange(23, device=ctx.device))

    n = samples.shape[1]
    _, j_pe = smpl_forward(smpl, mode, rot_pe, glob)
    _, j_s = smpl_forward(smpl, samples.reshape(b * n, -1), rot_all[:, 1:].reshape(b * n, 23, 3, 3),
                          glob[:, None].expand(b, n, 3, 3).reshape(b * n, 3, 3))
    proj = lambda j, c: c[..., None, 0:1] * (j[..., :2] + c[..., None, 1:3])  # noqa: E731
    j2d = torch.cat([proj(j_pe[:, COCO_FROM_SMPL90], cam)[:, None],
                     proj(j_s[:, COCO_FROM_SMPL90], cam[:, None].expand(b, n, 3).reshape(b * n, 3)).reshape(
                         b, n, 17, 2)], dim=1)

    weights = loss_cfg["WEIGHTS"]
    pose_nll = -torch.sum(pose_lp) / (b * 23)
    lp = -0.5 * ((batch["shape"] - mode) ** 2) / torch.exp(2.0 * log_std) - log_std - 0.5 * math.log(2 * math.pi)
    shape_nll = torch.mean(-torch.sum(lp, dim=1))
    img = cfg["DATA"]["PROXY_REP_SIZE"]
    target = ((2.0 * batch["joints2D"]) / img - 1.0)[:, None].expand(j2d.shape)
    vis = batch["joints2D_vis"][:, None].expand(j2d.shape[:-1]).float()
    j2d_loss = torch.sum(torch.sum((j2d - target) ** 2, dim=-1) * vis) / torch.clamp(torch.sum(vis) * 2, min=1.0)
    glob_loss = torch.mean((glob - batch["glob_rotmats"]) ** 2)
    total = (pose_nll * weights["POSE"] + shape_nll * weights["SHAPE"] + j2d_loss * weights["JOINTS2D"]
             + glob_loss * weights["GLOB_ROTMATS"])
    return total, {"pose_nll": pose_nll, "shape_nll": shape_nll, "joints2D": j2d_loss, "glob_rotmats": glob_loss}


class Adam:
    """Adam over a dict of float tensors, as torch.optim.Adam with its state
    made at the start (every parameter stepped, zero gradients included)."""

    def __init__(self, params: dict, lr: float, betas=(0.9, 0.999), eps: float = 1e-8):
        self.lr, self.betas, self.eps, self.t = lr, betas, eps, 0
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}

    @torch.no_grad()
    def step(self, params: dict, grads: dict):
        self.t += 1
        b1, b2 = self.betas
        for k, p in params.items():
            g = grads[k]
            self.m[k].mul_(b1).add_(g, alpha=1 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = (self.v[k].sqrt() / math.sqrt(1 - b2 ** self.t)).add_(self.eps)
            p.addcdiv_(self.m[k], denom, value=-self.lr / (1 - b1 ** self.t))


def train_step(w, trainable, smpl, cfg, batch, noise, adam):
    """One step in place on `w`'s trainable tensors; returns (loss terms and
    total as floats, the gradients as Adam got them)."""
    params = {k: w[k].requires_grad_(True) for k in trainable}
    total, terms = loss(w, smpl, cfg, batch, *noise)
    grads = torch.autograd.grad(total, list(params.values()), allow_unused=True)
    grads = {k: torch.zeros_like(p) if g is None else g for (k, p), g in zip(params.items(), grads)}
    for p in params.values():
        p.requires_grad_(False)
    gnorm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads.values()]))
    if bool(torch.isfinite(total.detach()) & torch.isfinite(gnorm)):
        adam.step(params, grads)
    return {**{k: float(v.detach()) for k, v in terms.items()}, "total": float(total.detach())}, grads

