"""Fused forward flow stack of one autoregressive depth level: kernel K5
(csrc/flow_level.cu) and its plain twin.

The counterpart of `humaniflow_tpu/flows/pallas_level.py` (`flow_forward_level`
with its kernel `_make_level_kernel`): one launch pushes a level's base
samples through every transform of the flow, Permute → spline-coupling
hypernet MLP → two linear-rational splines per coupling, then the radial
tanh, for all of the level's parts at once.  Forward (sampling) direction
only, no log-det, as in the JAX package.

The kernel reads the port's natural layouts: z (..., P, 3), ctx (..., P, C)
and the part-stacked DenseNN weights (num_parts, out, in) at the rows that
the level's `parts` index tensor names, so no per-level weight gather is
launched.  The TPU kernel's column reorder, the pad of the derivative block
from 7 to 8 and its transposed (features, rows) layout served the TPU's
vector registers and have no counterpart here.

`flow_forward_level` computes the twin when the tensors lie on the CPU.  For
CUDA tensors it launches K5, or raises on a wrong dtype, device, layout,
shape, flow structure or a width above what the kernel holds; it never falls
back.  `LAUNCHES` counts its kernel launches.
"""

import ctypes
import math
import weakref

import torch

from ..utils.cuda_build import load_library
from .factory import ConditionalFlow
from .transforms import ConditionalSplineCoupling, Permute, ScaledRadialTanh

LAUNCHES = {"flow_level": 0}

COUNT_BINS = 8  # the kernel is specialised to 8 spline bins (the default)
MAX_COUPLINGS = 8  # csrc/flow_level.cu kMaxCouplings
MAX_LAYERS = 8  # kMaxLayers
MAX_WIDTH = 128  # context and hidden widths the wrapper accepts
OUT_PAD = 32  # kOutPad: a layer's outputs are padded to a multiple of 32 in shared memory
MAX_SHARED_BYTES = 232448  # dynamic shared memory of one block on sm_90


def supports_flow(flow: ConditionalFlow) -> bool:
    """True when the flow matches the fused kernel's specialisation, by the
    JAX package's checks: event_dim 3, blocks of [Permute,
    ConditionalSplineCoupling(count_bins=8, split 1+2, ≥ 1 hidden layer)]
    and an optional trailing ScaledRadialTanh."""
    ts = flow.transforms
    if flow.event_dim != 3 or len(ts) == 0:
        return False
    i = 0
    n_couplings = 0
    while i < len(ts) and not isinstance(ts[i], ScaledRadialTanh):
        if not isinstance(ts[i], Permute):
            return False
        if i + 1 >= len(ts) or not isinstance(ts[i + 1], ConditionalSplineCoupling):
            return False
        c = ts[i + 1]
        if c.count_bins != COUNT_BINS or c.split != 1 or c.split + c.upper != 3:
            return False
        if len(c.hypernet.weights) < 2:
            return False
        i += 2
        n_couplings += 1
    if i == len(ts):
        return n_couplings > 0  # no compactification
    return i == len(ts) - 1 and isinstance(ts[i], ScaledRadialTanh)


def _plan(flow: ConditionalFlow):
    """[(permutation, coupling), ...] and the radial-tanh radius or None."""
    blocks, radius = [], None
    ts = flow.transforms
    for i in range(0, len(ts), 2):
        if isinstance(ts[i], ScaledRadialTanh):
            radius = ts[i].radius
            break
        blocks.append((ts[i].permutation, ts[i + 1]))
    return blocks, radius


def flow_forward_level_plain(flow: ConditionalFlow, z, ctx, parts):
    """Plain PyTorch twin of K5: the flow's eager forward under the kernel's
    signature.  z (..., P, 3), ctx (..., P, C), parts LongTensor (P,)."""
    return flow(z, ctx, parts)


class _Params(ctypes.Structure):
    """csrc/flow_level.cu FlowLevelParams, field for field."""

    _fields_ = [
        ("weight", (ctypes.c_void_p * MAX_LAYERS) * MAX_COUPLINGS),
        ("bias", (ctypes.c_void_p * MAX_LAYERS) * MAX_COUPLINGS),
        ("dims", (ctypes.c_int * (MAX_LAYERS + 1)) * MAX_COUPLINGS),
        ("perm", (ctypes.c_int * 3) * MAX_COUPLINGS),
        ("bound", ctypes.c_float * MAX_COUPLINGS),
        ("n_layers", ctypes.c_int * MAX_COUPLINGS),
        ("n_couplings", ctypes.c_int),
        ("num_parts", ctypes.c_int),
        ("radius", ctypes.c_float),
        ("weight_floats", ctypes.c_int),
        ("act_rows", ctypes.c_int),
    ]


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _check_tensor(name, t, device, shape, dtype=torch.float32):
    if t.device != device:
        raise ValueError(f"{name} must be a CUDA tensor on {device}, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def level_params(flow: ConditionalFlow, c_dim: int, device) -> _Params:
    """The kernel's parameter block for `flow` with context width c_dim;
    raises on a structure or a width the kernel does not take."""
    if not supports_flow(flow):
        raise ValueError("the flow does not match the fused level kernel (see supports_flow)")
    blocks, radius = _plan(flow)
    if len(blocks) > MAX_COUPLINGS:
        raise ValueError(f"at most {MAX_COUPLINGS} couplings are supported, got {len(blocks)}")
    if not 0 < c_dim <= MAX_WIDTH:
        raise ValueError(f"the context width must lie in [1, {MAX_WIDTH}], got {c_dim}")
    prm = _Params()
    num_parts = flow.transforms[1].hypernet.weights[0].shape[0]
    weight_floats = act_rows = 0
    for c, (perm, coupling) in enumerate(blocks):
        ws, bs = coupling.hypernet.weights, coupling.hypernet.biases
        if len(ws) > MAX_LAYERS:
            raise ValueError(f"at most {MAX_LAYERS} hypernet layers are supported, got {len(ws)}")
        dims = [ws[0].shape[2]] + [w.shape[1] for w in ws]
        if dims[0] != c_dim + 1:
            raise ValueError(f"coupling {c} takes {dims[0] - 1} context features, the contexts have {c_dim}")
        if max(dims[1:-1]) > MAX_WIDTH:
            raise ValueError(f"hidden widths above {MAX_WIDTH} are not supported: {dims[1:-1]}")
        if dims[-1] != 2 * (4 * COUNT_BINS - 1):
            raise ValueError(f"the hypernet's output width must be {2 * (4 * COUNT_BINS - 1)}, got {dims[-1]}")
        floats = 0
        for li, (w, b) in enumerate(zip(ws, bs)):
            _check_tensor(f"coupling {c} weight {li}", w, device, (num_parts, dims[li + 1], dims[li]))
            _check_tensor(f"coupling {c} bias {li}", b, device, (num_parts, dims[li + 1]))
            prm.weight[c][li] = w.data_ptr()
            prm.bias[c][li] = b.data_ptr()
            outp = _round_up(dims[li + 1], OUT_PAD)
            floats += outp * _round_up(dims[li], 4) + outp
            act_rows = max(act_rows, outp)
        weight_floats = max(weight_floats, floats)
        for li, d in enumerate(dims):
            prm.dims[c][li] = d
        for k in range(3):
            prm.perm[c][k] = perm[k]
        prm.bound[c] = coupling.bound
        prm.n_layers[c] = len(ws)
    prm.n_couplings = len(blocks)
    prm.num_parts = num_parts
    prm.radius = 0.0 if radius is None else radius
    prm.weight_floats = weight_floats
    prm.act_rows = act_rows
    return prm


def _library() -> ctypes.CDLL:
    lib = load_library("flow_level")
    if not getattr(lib, "_bound", False):
        lib.flow_level_params_size.argtypes = []
        lib.flow_level_params_size.restype = ctypes.c_int
        if lib.flow_level_params_size() != ctypes.sizeof(_Params):
            raise RuntimeError("FlowLevelParams differs between csrc/flow_level.cu and its ctypes mirror")
        lib.flow_level_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_void_p]
        lib.flow_level_smem_bytes.restype = ctypes.c_longlong
        lib.flow_level_launch.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        lib.flow_level_launch.restype = ctypes.c_int
        lib._bound = True
    return lib


_PLANS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()  # flow → {(c_dim, device): (tensors, _Params)}


def _cached_plan(flow: ConditionalFlow, c_dim: int, device) -> _Params:
    """level_params, checked against the block's shared-memory limit, built
    once per flow, context width and device, and again when a hypernet
    tensor moves or changes shape."""
    tensors = tuple((t.data_ptr(), tuple(t.shape)) for m in flow.transforms if hasattr(m, "hypernet")
                    for t in (*m.hypernet.weights, *m.hypernet.biases))
    plans = _PLANS.setdefault(flow, {})
    hit = plans.get((c_dim, device))
    if hit is None or hit[0] != tensors:
        prm = level_params(flow, c_dim, device)
        smem = _library().flow_level_smem_bytes(c_dim, ctypes.byref(prm))
        if smem > MAX_SHARED_BYTES:
            raise ValueError(f"the level needs {smem} B of shared memory per block, more than {MAX_SHARED_BYTES}")
        hit = plans[(c_dim, device)] = (tensors, prm)
    return hit[1]


def flow_forward_level(flow: ConditionalFlow, z, ctx, parts):
    """K5: one level's fused flow forward, z (..., P, 3), ctx (..., P, C),
    parts LongTensor (P,) of absolute part indices → x (..., P, 3)."""
    if z.device.type == "cpu":
        return flow_forward_level_plain(flow, z, ctx, parts)
    device = z.device
    if device.type != "cuda":
        raise ValueError(f"z must lie on a CUDA device or the CPU, got {device}")
    lead, p, c_dim = tuple(z.shape[:-2]), z.shape[-2], ctx.shape[-1]
    _check_tensor("z", z, device, lead + (p, 3))
    _check_tensor("ctx", ctx, device, lead + (p, c_dim))
    _check_tensor("parts", parts, device, (p,), dtype=torch.int64)
    prm = _cached_plan(flow, c_dim, device)
    rows = math.prod(lead)
    out = torch.empty_like(z)
    if rows == 0 or p == 0:
        return out
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = _library().flow_level_launch(z.data_ptr(), ctx.data_ptr(), parts.data_ptr(), out.data_ptr(), rows, p,
                                      c_dim, ctypes.byref(prm), stream)
    if rc != 0:
        raise RuntimeError(f"flow_level_launch failed with CUDA error {rc}")
    LAUNCHES["flow_level"] += 1
    return out
