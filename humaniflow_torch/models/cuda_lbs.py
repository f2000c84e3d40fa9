"""SMPL vertex kernels K1 and K2 (csrc/smpl_lbs.cu), the skinning kernel K7
(csrc/lbs_skin.cu), and their plain twins.

The counterpart of `humaniflow_tpu/models/pallas_lbs.py`:

* K2 `smpl_verts` (TPU: `_smpl_verts_kernel` via `smpl_verts_fused`):
  template + shape and pose blend shapes + linear blend skinning in one
  pass, written as (B, 3, V) vertices; one thread per vertex, with a
  group of rows per block that `forward_plan` chooses per call from (B, V).
* K1 `smpl_moments` (TPU: `_smpl_moments_kernel` via
  `smpl_verts_moments_fused`): the same vertices for G groups of N samples,
  reduced inside the kernel to (Σx, Σx²) over each group, (G, 2, 3, V); the
  (G·N, 3, V) sample vertices never reach memory.
* K7 `lbs_skin_cm` (TPU: `_lbs_kernel` via `lbs_skin_pallas_cm`): linear
  blend skinning of channel-major posed vertices (B, 3, V), with its
  gradient as `LBSSkin`.  No path calls it, in the JAX package (only its
  test, tests/test_pallas_lbs.py:22) or in the port: the SMPL forward fuses
  skinning into K1 and K2.

Each wrapper computes its plain PyTorch twin when the tensors lie on the
CPU.  For CUDA tensors it launches the kernel, or raises on a wrong dtype,
device, layout or shape; it never falls back.  `LAUNCHES` counts the kernel
launches of each wrapper (K2's backward kernel under
"smpl_verts_backward"), so a run can show that it went through the
kernels.  The kernels are built with
nvcc at first use (utils/cuda_build.py).

Gradients.  The forward kernels compute no gradient, so on CUDA their
wrappers raise when grad mode is on and an input requires grad, instead of
returning vertices with no grad_fn.  `SMPLVerts` (`smpl_verts_differentiable`)
is K2 with its gradient, on both devices: its forward is `smpl_verts`, its
backward the explicit adjoints of the JAX package's custom VJP
(`_fused_bwd`, `_lbs_bwd`, pallas_lbs.py:364-413).  Every adjoint follows
from two per-vertex tensors, dp (B, 3, V) and G12 = [g⊗p, g] (B, 12, V):
`smpl_verts_backward_vertex` computes them in one launch of K2's backward
kernel (csrc/smpl_lbs.cu; the plain twin on the CPU), and the reductions
over V are float32 matrix products shared by both devices, as JAX leaves
them to XLA einsums.  Each is computed only for the inputs that need it.

Argument layouts (float32): a12 (..., 24, 12) per-joint [R (row-major 9) | t]
rows, betas (..., NB), pose_feature (..., 207), v_template_cm (3, V),
shapedirs_cm (NB, 3, V), posedirs_cm (207, 3, V), lbs_weights (V, 24).
"""

import ctypes
import functools

import torch

from ..utils.cuda_build import load_library, refuse_grad

LAUNCHES = {"smpl_verts": 0, "smpl_moments": 0, "smpl_verts_backward": 0, "lbs_skin": 0}

NUM_JOINTS = 24
NUM_POSE_FEATURES = 207
MAX_BETAS = 16  # csrc/smpl_lbs.cu kMaxBetas
# K2's forward row groups, (rows, vertices) a block, in csrc/smpl_lbs.cu's
# plan order: the more rows a block, the fewer times the basis is read.
FORWARD_PLANS = ((16, 128), (8, 128), (4, 128))


def forward_plan(b: int, v: int, sms: int = 132) -> int:
    """The row group of K2's forward for b rows of v vertices on a card of
    `sms` SMs: the first (largest) of FORWARD_PLANS whose grid gives each SM
    three blocks, else the smallest.  A larger group reads the basis fewer
    times; a grid that leaves SMs short of blocks leaves the loads' latency
    unhidden (utils/profiling.py --plans times every group at the paths'
    row counts)."""
    for i, (rows, verts) in enumerate(FORWARD_PLANS):
        if -(-v // verts) * -(-b // rows) >= 3 * sms:
            return i
    return len(FORWARD_PLANS) - 1


def _posed_plain(betas, pose_feature, v_template_cm, shapedirs_cm, posedirs_cm):
    """(B, 3, V) posed vertices: template + shape and pose blend shapes."""
    b, v = betas.shape[0], v_template_cm.shape[1]
    return (
        v_template_cm
        + torch.einsum("bl,lcv->bcv", betas, shapedirs_cm)
        + torch.matmul(pose_feature, posedirs_cm.reshape(NUM_POSE_FEATURES, 3 * v)).reshape(b, 3, v)
    )


def smpl_verts_plain(a12, betas, pose_feature, v_template_cm, shapedirs_cm, posedirs_cm, lbs_weights):
    """Plain PyTorch twin of K2: (B, 3, V) skinned vertices."""
    v_posed = _posed_plain(betas, pose_feature, v_template_cm, shapedirs_cm, posedirs_cm)
    t12 = torch.einsum("vj,bjr->brv", lbs_weights, a12)
    return torch.stack(
        [
            t12[:, 3 * i] * v_posed[:, 0]
            + t12[:, 3 * i + 1] * v_posed[:, 1]
            + t12[:, 3 * i + 2] * v_posed[:, 2]
            + t12[:, 9 + i]
            for i in range(3)
        ],
        dim=1,
    )


def smpl_verts_moments_plain(a12, betas, pose_feature, v_template_cm, shapedirs_cm, posedirs_cm, lbs_weights):
    """Plain PyTorch twin of K1: a12 (G, N, 24, 12), betas (G, N, NB),
    pose_feature (G, N, 207) → (G, 2, 3, V) = (Σx, Σx²) over each group."""
    g, n = a12.shape[:2]
    verts = smpl_verts_plain(
        a12.reshape(g * n, NUM_JOINTS, 12),
        betas.reshape(g * n, -1),
        pose_feature.reshape(g * n, NUM_POSE_FEATURES),
        v_template_cm, shapedirs_cm, posedirs_cm, lbs_weights,
    ).reshape(g, n, 3, -1)
    return torch.stack([verts.sum(dim=1), (verts * verts).sum(dim=1)], dim=1)


def _check(rows_shape, a12, betas, pose_feature, v_template_cm, shapedirs_cm, posedirs_cm, lbs_weights):
    """Raise unless every argument is a contiguous, 16-byte aligned float32
    CUDA tensor on one device with the shapes the kernel expects."""
    v = v_template_cm.shape[-1]
    nb = betas.shape[-1]
    expected = {
        "a12": (a12, rows_shape + (NUM_JOINTS, 12)),
        "betas": (betas, rows_shape + (nb,)),
        "pose_feature": (pose_feature, rows_shape + (NUM_POSE_FEATURES,)),
        "v_template_cm": (v_template_cm, (3, v)),
        "shapedirs_cm": (shapedirs_cm, (nb, 3, v)),
        "posedirs_cm": (posedirs_cm, (NUM_POSE_FEATURES, 3, v)),
        "lbs_weights": (lbs_weights, (v, NUM_JOINTS)),
    }
    device = a12.device
    for name, (t, shape) in expected.items():
        if t.device != device or t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor on {device}, got {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if nb > MAX_BETAS:
        raise ValueError(f"at most {MAX_BETAS} betas are supported, got {nb}")


_LAUNCHERS = {  # C entry point → (csrc source, argument types)
    "smpl_verts_launch": ("smpl_lbs", [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p]),
    "smpl_moments_launch": ("smpl_lbs", [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p]),
    "lbs_skin_launch": ("lbs_skin", [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_void_p]),
    "smpl_verts_bwd_launch": ("smpl_lbs", [ctypes.c_void_p] * 8 + [ctypes.c_longlong] * 3 + [ctypes.c_void_p] * 2
                              + [ctypes.c_int] * 3 + [ctypes.c_void_p]),
}


def _launcher(name: str):
    source, argtypes = _LAUNCHERS[name]
    fn = getattr(load_library(source), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _launch(name: str, tensors, out, ints):
    fn = _launcher(name)
    stream = torch.cuda.current_stream(out.device).cuda_stream
    rc = fn(*(t.data_ptr() for t in tensors), out.data_ptr(), *ints, stream)
    if rc != 0:
        raise RuntimeError(f"{name} failed with CUDA error {rc}")


def smpl_verts(a12, betas, pose_feature, v_template_cm, shapedirs_cm, posedirs_cm, lbs_weights):
    """K2: (B, 3, V) skinned vertices.  a12 (B, 24, 12), betas (B, NB),
    pose_feature (B, 207).  No gradient on CUDA: use
    smpl_verts_differentiable for one."""
    args = (a12, betas, pose_feature, v_template_cm, shapedirs_cm, posedirs_cm, lbs_weights)
    if a12.device.type == "cpu":
        return smpl_verts_plain(*args)
    refuse_grad("K2 (smpl_verts)", *args)
    b = betas.shape[0]
    _check((b,), *args)
    out = _smpl_verts_launch(args, forward_plan(b, v_template_cm.shape[1], _sm_count(a12.device)))
    LAUNCHES["smpl_verts"] += 1
    return out


def _smpl_verts_launch(args, plan: int):
    """Launch K2's forward on checked arguments with the row group FORWARD_PLANS[plan]."""
    b, v = args[1].shape[0], args[3].shape[1]
    out = torch.empty((b, 3, v), dtype=torch.float32, device=args[0].device)
    _launch("smpl_verts_launch", args, out, (b, v, args[1].shape[1], plan))
    return out


def smpl_moments(a12, betas, pose_feature, v_template_cm, shapedirs_cm, posedirs_cm, lbs_weights):
    """K1: (G, 2, 3, V) per-group (Σx, Σx²).  a12 (G, N, 24, 12), betas
    (G, N, NB), pose_feature (G, N, 207)."""
    args = (a12, betas, pose_feature, v_template_cm, shapedirs_cm, posedirs_cm, lbs_weights)
    if a12.device.type == "cpu":
        return smpl_verts_moments_plain(*args)
    refuse_grad("K1 (smpl_moments)", *args)
    g, n = betas.shape[:2]
    if n == 0:
        raise ValueError("smpl_moments needs at least one sample per group")
    _check((g, n), *args)
    v = v_template_cm.shape[1]
    out = torch.empty((g, 2, 3, v), dtype=torch.float32, device=a12.device)
    _launch("smpl_moments_launch", args, out, (g, n, v, betas.shape[2]))
    LAUNCHES["smpl_moments"] += 1
    return out


def _dp_plain(grad, lbs_weights, a12):
    """dp[b,i,v] = Σ_c T12[b,3c+i,v]·g[b,c,v], T12 = W·A12 (rotation part)."""
    b, _, v = grad.shape
    rot = torch.einsum("vj,bjr->brv", lbs_weights, a12[..., :9])  # (B, 9, V)
    return torch.einsum("bciv,bcv->biv", rot.reshape(b, 3, 3, v), grad)


def _g12_plain(grad, v_posed_cm):
    """G12[b,r,v]: r = 3c+i → g[b,c,v]·p[b,i,v]; r = 9+c → g[b,c,v]."""
    b, _, v = grad.shape
    return torch.cat([torch.einsum("bcv,biv->bciv", grad, v_posed_cm).reshape(b, 9, v), grad], dim=1)


def _require_full_float32(device):
    """Raise on CUDA when float32 matmuls may run in TF32: the adjoints'
    products must keep float32's precision."""
    if device.type == "cuda" and (
        torch.backends.cuda.matmul.allow_tf32 or torch.get_float32_matmul_precision() != "highest"
    ):
        raise RuntimeError(
            "K2's backward needs full float32 matmuls: torch.backends.cuda.matmul.allow_tf32 is "
            f"{torch.backends.cuda.matmul.allow_tf32}, the float32 matmul precision "
            f"{torch.get_float32_matmul_precision()!r} (expected False and 'highest')"
        )


def _lbs_products(g12, need_w, need_a, lbs_weights, a12):
    """(dW (V, 24) = Σ_b G12ᵀ·a12ᵀ, dA12 (B, 24, 12) = (G12·W)ᵀ) from
    G12 (B, 12, V), None where not needed."""
    b, _, v = g12.shape
    flat = g12.reshape(b * 12, v)
    dw = torch.matmul(flat.T, a12.transpose(1, 2).reshape(b * 12, NUM_JOINTS)) if need_w else None
    da = torch.matmul(flat, lbs_weights).reshape(b, 12, NUM_JOINTS).transpose(1, 2) if need_a else None
    return dw, da


def lbs_skin_backward(grad, needs, lbs_weights, a12, v_posed_cm):
    """Adjoints of out[b,c,v] = Σ_j W[v,j]·(Σ_i R_j[c,i]·p[b,i,v] + t_j[c])
    with cotangent `grad` (B, 3, V): (dW (V, 24), da12 (B, 24, 12),
    dp (B, 3, V)), None where needs[i] is False (JAX: pallas_lbs.py
    `_lbs_bwd`).  v_posed_cm is read only for dW and da12."""
    _require_full_float32(grad.device)
    g12 = _g12_plain(grad, v_posed_cm) if needs[0] or needs[1] else None
    dw, da = _lbs_products(g12, needs[0], needs[1], lbs_weights, a12) if g12 is not None else (None, None)
    return dw, da, _dp_plain(grad, lbs_weights, a12) if needs[2] else None


def smpl_verts_backward_vertex_plain(grad, need_dp, need_g12, a12, betas, pose_feature, v_template_cm,
                                     shapedirs_cm, posedirs_cm, lbs_weights):
    """Plain PyTorch twin of K2's backward kernel: (dp (B, 3, V),
    G12 (B, 12, V)) for cotangent `grad` (B, 3, V), None where not needed."""
    dp = _dp_plain(grad, lbs_weights, a12) if need_dp else None
    g12 = None
    if need_g12:
        g12 = _g12_plain(grad, _posed_plain(betas, pose_feature, v_template_cm, shapedirs_cm, posedirs_cm))
    return dp, g12


def smpl_verts_backward_vertex(grad, need_dp, need_g12, a12, betas, pose_feature, v_template_cm, shapedirs_cm,
                               posedirs_cm, lbs_weights):
    """K2's backward kernel: (dp (B, 3, V), G12 (B, 12, V)), each None
    unless needed, in one launch; `grad` (B, 3, V) float32 in any strides.
    The plain twin on the CPU."""
    args = (a12, betas, pose_feature, v_template_cm, shapedirs_cm, posedirs_cm, lbs_weights)
    if grad.device.type == "cpu":
        return smpl_verts_backward_vertex_plain(grad, need_dp, need_g12, *args)
    b, v = betas.shape[0], v_template_cm.shape[1]
    _check((b,), *args)
    if grad.device != a12.device or grad.dtype != torch.float32 or tuple(grad.shape) != (b, 3, v):
        raise ValueError(f"grad must be a float32 (B, 3, V) = {(b, 3, v)} tensor on {a12.device}, got "
                         f"{grad.dtype} {tuple(grad.shape)} on {grad.device}")
    if not (need_dp or need_g12):
        return None, None
    dp = torch.empty((b, 3, v), dtype=torch.float32, device=grad.device) if need_dp else None
    g12 = torch.empty((b, 12, v), dtype=torch.float32, device=grad.device) if need_g12 else None
    rc = _launcher("smpl_verts_bwd_launch")(
        *(t.data_ptr() for t in args), grad.data_ptr(), *grad.stride(),
        None if dp is None else dp.data_ptr(), None if g12 is None else g12.data_ptr(),
        b, v, betas.shape[1], torch.cuda.current_stream(grad.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"smpl_verts_bwd_launch failed with CUDA error {rc}")
    LAUNCHES["smpl_verts_backward"] += 1
    return dp, g12


def smpl_verts_backward(grad, needs, a12, betas, pose_feature, v_template_cm, shapedirs_cm, posedirs_cm,
                        lbs_weights):
    """Adjoints of the (B, 3, V) vertices with cotangent `grad` (B, 3, V) for
    the seven inputs of smpl_verts, None where needs[i] is False (JAX:
    pallas_lbs.py `_fused_bwd`): dp and G12 from K2's backward kernel (its
    twin on the CPU), then float32 products over V."""
    _require_full_float32(grad.device)
    b, nb, v = betas.shape[0], betas.shape[1], v_template_cm.shape[1]
    dp, g12 = smpl_verts_backward_vertex(
        grad, any(needs[1:6]), needs[0] or needs[6],
        a12, betas, pose_feature, v_template_cm, shapedirs_cm, posedirs_cm, lbs_weights,
    )
    dw, da = _lbs_products(g12, needs[6], needs[0], lbs_weights, a12) if g12 is not None else (None, None)
    dp_flat = dp.reshape(b, 3 * v) if dp is not None else None
    return (
        da,
        torch.matmul(dp_flat, shapedirs_cm.reshape(nb, 3 * v).T) if needs[1] else None,
        torch.matmul(dp_flat, posedirs_cm.reshape(NUM_POSE_FEATURES, 3 * v).T) if needs[2] else None,
        dp.sum(dim=0) if needs[3] else None,
        torch.matmul(betas.T, dp_flat).reshape(nb, 3, v) if needs[4] else None,
        torch.matmul(pose_feature.T, dp_flat).reshape(NUM_POSE_FEATURES, 3, v) if needs[5] else None,
        dw,
    )


class SMPLVerts(torch.autograd.Function):
    """K2 with its gradient: forward `smpl_verts` (the kernel on CUDA, the
    plain twin on the CPU), backward `smpl_verts_backward`."""

    @staticmethod
    def forward(ctx, a12, betas, pose_feature, v_template_cm, shapedirs_cm, posedirs_cm, lbs_weights):
        ctx.save_for_backward(a12, betas, pose_feature, v_template_cm, shapedirs_cm, posedirs_cm, lbs_weights)
        return smpl_verts(a12, betas, pose_feature, v_template_cm, shapedirs_cm, posedirs_cm, lbs_weights)

    @staticmethod
    def backward(ctx, grad):
        return smpl_verts_backward(grad, ctx.needs_input_grad, *ctx.saved_tensors)


def smpl_verts_differentiable(a12, betas, pose_feature, v_template_cm, shapedirs_cm, posedirs_cm, lbs_weights):
    """K2 with its gradient (SMPLVerts); arguments as smpl_verts."""
    return SMPLVerts.apply(a12, betas, pose_feature, v_template_cm, shapedirs_cm, posedirs_cm, lbs_weights)


def lbs_skin_cm_plain(lbs_weights, a12, v_posed_cm):
    """Plain PyTorch twin of K7: (B, 3, V) skinned vertices."""
    t12 = torch.einsum("vj,bjr->brv", lbs_weights, a12)
    return torch.stack(
        [
            t12[:, 3 * i] * v_posed_cm[:, 0]
            + t12[:, 3 * i + 1] * v_posed_cm[:, 1]
            + t12[:, 3 * i + 2] * v_posed_cm[:, 2]
            + t12[:, 9 + i]
            for i in range(3)
        ],
        dim=1,
    )


def lbs_skin_cm(lbs_weights, a12, v_posed_cm):
    """K7: (B, 3, V) skinned vertices from lbs_weights (V, 24), a12
    (B, 24, 12) and channel-major posed vertices v_posed_cm (B, 3, V).  No
    gradient on CUDA: use LBSSkin.apply for one."""
    if a12.device.type == "cpu":
        return lbs_skin_cm_plain(lbs_weights, a12, v_posed_cm)
    refuse_grad("K7 (lbs_skin_cm)", lbs_weights, a12, v_posed_cm)
    b, _, v = v_posed_cm.shape
    expected = {"lbs_weights": (lbs_weights, (v, NUM_JOINTS)), "a12": (a12, (b, NUM_JOINTS, 12)),
                "v_posed_cm": (v_posed_cm, (b, 3, v))}
    for name, (t, shape) in expected.items():
        if t.device != a12.device or t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor on {a12.device}, got {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    out = torch.empty((b, 3, v), dtype=torch.float32, device=a12.device)
    fn = _launcher("lbs_skin_launch")
    rc = fn(lbs_weights.data_ptr(), a12.data_ptr(), v_posed_cm.data_ptr(), out.data_ptr(), b, v,
            torch.cuda.current_stream(a12.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"lbs_skin_launch failed with CUDA error {rc}")
    LAUNCHES["lbs_skin"] += 1
    return out


class LBSSkin(torch.autograd.Function):
    """K7 with its gradient: forward `lbs_skin_cm` (the kernel on CUDA, the
    plain twin on the CPU), backward `lbs_skin_backward`."""

    @staticmethod
    def forward(ctx, lbs_weights, a12, v_posed_cm):
        ctx.save_for_backward(lbs_weights, a12, v_posed_cm)
        return lbs_skin_cm(lbs_weights, a12, v_posed_cm)

    @staticmethod
    def backward(ctx, grad):
        return lbs_skin_backward(grad.contiguous(), ctx.needs_input_grad, *ctx.saved_tensors)
