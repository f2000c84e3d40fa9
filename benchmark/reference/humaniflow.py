"""HuManiFlow distribution inference, plain: ResNet encoder (eval-mode
BatchNorm), shape / global-rotation / camera heads, and the
ancestor-conditioned spline-coupling SO(3) flows of the 23 body parts, run
level by level of the kinematic tree; then SMPL for the point estimate, the
T-pose and every sample, and the per-vertex uncertainty.

Weights are a flat dict keyed as the model's checkpoint (`encoder.*`,
`fc1.*`, `fc_shape.*`, `fc_glob.*`, `fc_cam.*`, `fc_isgc.*`,
`fc_flow_context_*`, `flow.transforms.<i>.hypernet.{weights,biases}.<l>`).
The model configuration is the `model` group of a benchmark configuration
file.  The flow is the default one: per transform a cyclic-shift permutation
and a conditional linear-rational spline coupling, then a radial tanh.
"""

import torch
import torch.nn.functional as F

from .common import bn_batch, rot6d_to_rotmat, so3_exp
from .common import bn_eval as bn_running
from .proxy import build_proxy
from .smpl import SMPL_PARENTS, smpl_forward, vertex_uncertainty

INIT_CAM = (0.9, 0.0, 0.0)
INIT_GLOB_6D = (1.0, 0.0, 0.0, 1.0, 0.0, 0.0)
RESNET_STAGES = {18: (2, 2, 2, 2)}
MIN_BIN_WIDTH = MIN_BIN_HEIGHT = MIN_DERIVATIVE = 1e-3
MIN_LAMBDA = 0.025
SPLINE_EPS = 1e-6


# ------------------------------------------------------------------ encoder
def encoder(w, proxy, num_layers: int = 18, train: bool = False):
    """(B, H, W, C) NHWC proxy → (B, 512) pooled features (BasicBlocks);
    BatchNorm on its running statistics, or with train on the batch's."""
    bn_eval = bn_batch if train else bn_running
    x = proxy.permute(0, 3, 1, 2)
    x = F.relu(bn_eval(F.conv2d(x, w["encoder.conv1.weight"], stride=2, padding=3), w, "encoder.bn1"))
    x = F.max_pool2d(x, 3, 2, padding=1)
    for i, blocks in enumerate(RESNET_STAGES[num_layers]):
        for j in range(blocks):
            p = f"encoder.blocks.layer{i + 1}_block{j}"
            stride = 2 if i > 0 and j == 0 else 1
            y = F.relu(bn_eval(F.conv2d(x, w[f"{p}.conv1.weight"], stride=stride, padding=1), w, f"{p}.bn1"))
            y = bn_eval(F.conv2d(y, w[f"{p}.conv2.weight"], padding=1), w, f"{p}.bn2")
            if f"{p}.downsample_conv.weight" in w:
                x = bn_eval(F.conv2d(x, w[f"{p}.downsample_conv.weight"], stride=stride), w, f"{p}.downsample_bn")
            x = F.relu(y + x)
    return x.mean(dim=(2, 3))


def _linear(w, name, x):
    return F.linear(x, w[f"{name}.weight"], w[f"{name}.bias"])


# ------------------------------------------------------------------- flows
def ancestors():
    """Per body part (SMPL joint i+1) its ancestor parts, nearest first, and
    the parts grouped by depth in the kinematic tree."""
    anc = {}
    for i in range(1, len(SMPL_PARENTS)):
        parent = SMPL_PARENTS[i] - 1
        anc[i - 1] = ([parent] + anc[parent]) if parent >= 0 else []
    depth = {}
    for part, a in anc.items():
        depth.setdefault(len(a), []).append(part)
    return anc, [sorted(depth[d]) for d in sorted(depth)]


def _knots(unnorm, bound, min_frac):
    k = unnorm.shape[-1]
    cum = torch.cumsum(min_frac + (1.0 - min_frac * k) * torch.softmax(unnorm, dim=-1), dim=-1)
    cum = 2.0 * bound * F.pad(cum, (1, 0)) - bound
    cum = torch.cat([torch.full_like(cum[..., :1], -bound), cum[..., 1:-1], torch.full_like(cum[..., :1], bound)], -1)
    return cum[..., 1:] - cum[..., :-1], cum


def spline_forward(x, w_un, h_un, d_un, l_un, bound):
    """Monotonic linear-rational spline x → y, the identity outside ±bound."""
    inside = (x >= -bound) & (x <= bound)
    v = torch.clamp(x, -bound, bound)
    widths, cumw = _knots(w_un, bound, MIN_BIN_WIDTH)
    heights, cumh = _knots(h_un, bound, MIN_BIN_HEIGHT)
    pad = torch.full_like(d_un[..., :1], 1.0 - MIN_DERIVATIVE)
    derivs = torch.cat([pad, MIN_DERIVATIVE + F.softplus(d_un), pad], dim=-1)
    lambdas = (1.0 - 2.0 * MIN_LAMBDA) * torch.sigmoid(l_un) + MIN_LAMBDA
    idx = torch.clamp(torch.sum(v[..., None] >= (cumw + SPLINE_EPS), dim=-1, keepdim=True) - 1, 0, cumw.shape[-1] - 2)
    g = lambda t: torch.gather(t, -1, idx)[..., 0]  # noqa: E731
    in_w, in_cw, in_ch, in_h = g(widths), g(cumw[..., :-1]), g(cumh[..., :-1]), g(heights)
    delta, d0, d1, lam = g(heights / widths), g(derivs[..., :-1]), g(derivs[..., 1:]), g(lambdas)
    wa = torch.ones_like(d0)
    wb = torch.sqrt(d0 / d1) * wa
    wc = (lam * wa * d0 + (1.0 - lam) * wb * d1) / delta
    ya, yb = in_ch, in_h + in_ch
    yc = ((1.0 - lam) * wa * ya + lam * wb * yb) / ((1.0 - lam) * wa + lam * wb)
    theta = (v - in_cw) / in_w
    lo = theta <= lam
    num = torch.where(lo, wa * ya * (lam - theta) + wc * yc * theta, wc * yc * (1.0 - theta) + wb * yb * (theta - lam))
    den = torch.where(lo, wa * (lam - theta) + wc * theta, wc * (1.0 - theta) + wb * (theta - lam))
    return torch.where(inside, num / den, x)


def flow_forward(w, flow_cfg, z, ctx, parts):
    """Push base samples z (..., P, 3) through the flow under contexts
    (..., P, C) of the parts `parts` (LongTensor (P,))."""
    k = flow_cfg["NUM_SPLINE_SEGMENTS"]
    bound = flow_cfg["COMPACT_SUPPORT_RADIUS"]
    x = z
    for i in range(flow_cfg["NUM_TRANSFORMS"]):
        s = i % 3
        x = x[..., [(s + j) % 3 for j in range(3)]]
        t = 2 * i + 1
        h = torch.cat([ctx.expand(x.shape[:-1] + ctx.shape[-1:]), x[..., :1]], dim=-1)
        n_layers = len(flow_cfg["TRANSFORM_NN_HIDDEN_DIMS"]) + 1
        for layer in range(n_layers):
            wt = w[f"flow.transforms.{t}.hypernet.weights.{layer}"][parts]
            h = torch.einsum("...pi,poi->...po", h, wt) + w[f"flow.transforms.{t}.hypernet.biases.{layer}"][parts]
            if layer < n_layers - 1:
                h = torch.relu(h)
        sh = h.shape[:-1]
        wu, hu, du, lu = torch.split(h, (2 * k, 2 * k, 2 * (k - 1), 2 * k), dim=-1)
        y2 = spline_forward(x[..., 1:], wu.reshape(sh + (2, k)), hu.reshape(sh + (2, k)),
                            du.reshape(sh + (2, k - 1)), lu.reshape(sh + (2, k)), bound)
        x = torch.cat([x[..., :1], y2], dim=-1)
    r = flow_cfg["COMPACT_SUPPORT_RADIUS"]
    norm_sq = torch.sum(x * x, dim=-1, keepdim=True)
    small = norm_sq < 1e-14
    norm = torch.sqrt(torch.where(small, torch.ones_like(norm_sq), norm_sq))
    return x * torch.where(small, torch.ones_like(norm), torch.tanh(norm / r) * r / norm)


# ------------------------------------------------------------------- model
def heads(w, model_cfg, feats):
    """(cam (B, 3), global rotation (B, 3, 3), shape mode, shape log-std)."""
    nb = model_cfg["NUM_SMPL_BETAS"]
    x = F.elu(_linear(w, "fc1", feats))
    cam = _linear(w, "fc_cam", x) + torch.tensor(INIT_CAM, device=x.device)
    glob = rot6d_to_rotmat(_linear(w, "fc_glob", x) + torch.tensor(INIT_GLOB_6D, device=x.device))
    shape = _linear(w, "fc_shape", x)
    return cam, glob, shape[:, :nb], shape[:, nb:]


def isgc_features(w, feats, shape, glob, cam):
    """The input-shape-glob-cam features of shapes (B, S, nb)."""
    b, s = shape.shape[:2]
    x = torch.cat([feats[:, None].expand(b, s, feats.shape[-1]), shape, glob.reshape(b, 1, 9).expand(b, s, 9),
                   cam[:, None].expand(b, s, 3)], dim=-1)
    return F.elu(_linear(w, "fc_isgc", x))


def part_contexts(w, isgc, rot_buf, level):
    """Flow contexts (..., P, C) of the parts in `level` from isgc (..., D) and
    the rotations of all 23 parts (..., 23, 3, 3), ancestors nearest first."""
    anc, _ = ancestors()
    max_anc = max(len(a) for a in anc.values())
    dev = isgc.device
    anc_idx = torch.zeros((len(level), max_anc), dtype=torch.long)
    anc_mask = torch.zeros((len(level), max_anc))
    for r, p in enumerate(level):
        anc_idx[r, :len(anc[p])] = torch.tensor(anc[p], dtype=torch.long)
        anc_mask[r, :len(anc[p])] = 1.0
    lead = rot_buf.shape[:-3]
    a = rot_buf.reshape(lead + (23, 9))[..., anc_idx.to(dev), :] * anc_mask.to(dev)[..., None]
    a = a.reshape(lead + (len(level), 9 * max_anc))
    ctx_in = torch.cat([isgc[..., None, :].expand(lead + (len(level), isgc.shape[-1])), a], dim=-1)
    parts = torch.tensor(level, device=dev)
    ctx = torch.einsum("...pi,poi->...po", ctx_in, w["fc_flow_context_weight"][parts])
    return F.elu(ctx + w["fc_flow_context_bias"][parts])


def autoregress(w, flow_cfg, isgc, base_noise):
    """The level-by-level pass over rows (B, S): sample 0 with zero noise
    (the flow's mode), samples 1.. with `base_noise` (per level (B, S-1, P, 3))."""
    b, s = isgc.shape[:2]
    so3_buf = isgc.new_zeros((b, s, 23, 3))
    rot_buf = isgc.new_zeros((b, s, 23, 3, 3))
    for li, level in enumerate(ancestors()[1]):
        parts = torch.tensor(level, device=isgc.device)
        ctx = part_contexts(w, isgc, rot_buf, level)
        noise = torch.cat([torch.zeros_like(base_noise[li][:, :1]), base_noise[li]], dim=1)
        xs = flow_forward(w, flow_cfg, noise * flow_cfg["BASE_DIST_STD"], ctx, parts)
        so3_buf[..., parts, :] = xs
        rot_buf[..., parts, :, :] = so3_exp(xs)
    return so3_buf, rot_buf


def distribution(w, model_cfg, proxy, base_noise):
    """Heads and the (B, N+1) autoregressive pass, sample 0 the point
    estimate (zero noise, the shape mode), the others with `base_noise`
    (per level (B, N, P, 3)).  Samples use the shape mode."""
    feats = encoder(w, proxy, model_cfg["NUM_RESNET_LAYERS"])
    cam, glob, shape_mode, shape_log_std = heads(w, model_cfg, feats)
    b, n = base_noise[0].shape[:2]
    shape_all = shape_mode[:, None].expand(b, n + 1, shape_mode.shape[-1])
    so3_buf, rot_buf = autoregress(w, model_cfg["NORM_FLOW"], isgc_features(w, feats, shape_all, glob, cam),
                                   base_noise)
    return {"cam_wp": cam, "glob_rotmat": glob, "shape_mode": shape_mode, "shape_log_std": shape_log_std,
            "pose_axisangle_point_est": so3_buf[:, 0], "pose_rotmats_point_est": rot_buf[:, 0],
            "pose_rotmats_samples": rot_buf[:, 1:], "shape_samples": shape_all[:, 1:]}


def predict(w, smpl, cfg, images, joints2d, joints2d_conf, base_noise, visib_threshold: float = 0.75):
    """The whole prediction of a batch: proxy, distribution, SMPL of the point
    estimate, the T-pose and every sample, the per-vertex uncertainty."""
    proxy = build_proxy(images, joints2d, joints2d_conf, cfg["DATA"], visib_threshold)
    out = distribution(w, cfg["MODEL"], proxy, base_noise)
    b, n = out["pose_rotmats_samples"].shape[:2]
    glob = out["glob_rotmat"]
    pe_v, pe_j = smpl_forward(smpl, out["shape_mode"], out["pose_rotmats_point_est"], glob)
    eye = torch.eye(3, device=glob.device)
    tpose_v, _ = smpl_forward(smpl, out["shape_mode"], eye.expand(b, 23, 3, 3), eye.expand(b, 3, 3))
    sv, sj = smpl_forward(smpl, out["shape_samples"].reshape(b * n, -1),
                          out["pose_rotmats_samples"].reshape(b * n, 23, 3, 3),
                          glob[:, None].expand(b, n, 3, 3).reshape(b * n, 3, 3))
    sv = sv.reshape(b, n, -1, 3)
    l2, directional = vertex_uncertainty(sv)
    out.update(proxy_rep=proxy, verts_point_est=pe_v, joints_point_est=pe_j, tpose_verts=tpose_v,
               verts_samples=sv, joints_samples=sj.reshape(b, n, -1, 3), vertex_uncertainty_l2=l2,
               vertex_uncertainty_directional=directional)
    return out

