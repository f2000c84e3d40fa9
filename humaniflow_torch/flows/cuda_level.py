"""Fused forward flow stack of one autoregressive depth level: kernel K5
(csrc/flow_level.cu) and its plain twin.

The counterpart of `humaniflow_tpu/flows/pallas_level.py` (`flow_forward_level`
with its kernel `_make_level_kernel`): one launch pushes a level's base
samples through every transform of the flow, Permute → spline-coupling
hypernet MLP → two linear-rational splines per coupling, then the radial
tanh, for all of the level's parts at once.  Forward (sampling) direction
only, no log-det, as in the JAX package.

The kernel reads z (..., P, 3) and ctx (..., P, C) in the port's natural
layouts, and the hypernet weights packed by `level_pack`: for each part and
coupling one contiguous buffer, laid out in the order the kernel reads its
tensor-core (mma.sync m16n8k8) fragments.  The pack is made on the weights'
device, once, and kept in the plan cache until a hypernet tensor moves,
changes shape or is written in place (its `_version`, which
`load_state_dict` and optimiser steps bump).  A block carries 64 rows of one
part, 16 a warp.  The TPU kernel's column reorder, the pad of the derivative
block from 7 to 8 and its transposed (features, rows) layout served the
TPU's vector registers; the pack here serves the mma fragments.

`flow_forward_level` computes the twin when the tensors lie on the CPU.  For
CUDA tensors it launches K5, or raises on a wrong dtype, device, layout,
shape, flow structure or a width above what the kernel holds; it never falls
back.  K5 has no backward (nor has the JAX kernel): on CUDA it raises when
grad mode is on and z, ctx or the flow's weights require grad.  `LAUNCHES`
counts its kernel launches, which the spans of utils/tracing.py read; a
launch recorded into a CUDA graph's capture is not counted (it runs at the
graph's replays, which the device trace sees).
"""

import ctypes
import math
import weakref

import numpy as np
import torch

from ..utils.cuda_build import load_library, refuse_grad
from ..utils.tracing import launch_counter
from .factory import ConditionalFlow
from .transforms import ConditionalSplineCoupling, Permute, ScaledRadialTanh

LAUNCHES = launch_counter({"flow_level": 0})

COUNT_BINS = 8  # the kernel is specialised to 8 spline bins (the default)
MAX_COUPLINGS = 8  # csrc/flow_level.cu kMaxCouplings
MAX_LAYERS = 8  # kMaxLayers
MAX_WIDTH = 128  # context and hidden widths the wrapper accepts
WARPS = 4  # kWarps: a block's warps, 16 rows (one mma tile) each
SCRATCH_FLOATS = 64 * 18  # kScratchFloats: a warp's spline scratch
MAX_SHARED_BYTES = 232448  # dynamic shared memory of one block on sm_90
# The last layer's 62 outputs w (2, 8), h (2, 8), d (2, 7), l (2, 8) as the
# kernel reads them: 8 columns per (kind, dimension), d's 8th a zero pad.
_PARAM_KINDS = ((0, 8), (16, 8), (32, 7), (46, 8))  # (first output, bins per dimension)


def supports_flow(flow: ConditionalFlow) -> bool:
    """True when K5 runs the flow: the structure the kernel is specialised
    to (`_matches_kernel`, the JAX package's checks) within every limit
    that `level_params` enforces at the flow's own context width: couplings,
    hypernet layers, widths and a block's shared memory.  The model routes a
    pass to K5 by this, so a flow it accepts never makes the wrapper raise."""
    if not _matches_kernel(flow):
        return False
    try:
        _layout(flow, flow.transforms[1].hypernet.weights[0].shape[2] - 1)
    except ValueError:
        return False
    return True


def _matches_kernel(flow: ConditionalFlow) -> bool:
    """The JAX package's checks: event_dim 3, blocks of [Permute,
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
        ("packed", ctypes.c_void_p),
        ("layer_off", (ctypes.c_int * MAX_LAYERS) * MAX_COUPLINGS),
        ("layer_floats", (ctypes.c_int * MAX_LAYERS) * MAX_COUPLINGS),
        ("k_steps", (ctypes.c_int * MAX_LAYERS) * MAX_COUPLINGS),
        ("n_tiles", (ctypes.c_int * MAX_LAYERS) * MAX_COUPLINGS),
        ("perm", (ctypes.c_int * 3) * MAX_COUPLINGS),
        ("bound", ctypes.c_float * MAX_COUPLINGS),
        ("n_layers", ctypes.c_int * MAX_COUPLINGS),
        ("n_couplings", ctypes.c_int),
        ("num_parts", ctypes.c_int),
        ("coupling_floats", ctypes.c_int),
        ("c_dim", ctypes.c_int),
        ("max_tiles", ctypes.c_int),
        ("radius", ctypes.c_float),
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


def _output_columns(width: int, last: bool) -> np.ndarray:
    """For each packed output column of a layer, the output feature it
    holds, −1 for a pad: hidden layers in order, padded to a multiple of 16;
    the last layer as _PARAM_KINDS."""
    if not last:
        cols = np.arange(_round_up(width, 16))
        return np.where(cols < width, cols, -1)
    cols = np.arange(64)
    kind, dim, b = cols // 16, cols % 16 // 8, cols % 8
    first = np.array([k[0] for k in _PARAM_KINDS])[kind]
    bins = np.array([k[1] for k in _PARAM_KINDS])[kind]
    return np.where(b < bins, first + dim * bins + b, -1)


def _input_features(layer: int, c_dim: int, prev_columns: np.ndarray) -> np.ndarray:
    """(k-steps, 8): the input feature (−1: zero) behind logical k of each
    k-step.  The first layer: k-step 2q + h takes context features 16q + 4t
    + 2h (k = t) and 16q + 4t + 2h + 1 (k = t + 4), as a lane's float4 of
    the contexts holds them.  A later layer: the previous accumulator's
    column 8·ks + 2t (k = t) and 8·ks + 2t + 1 (k = t + 4)."""
    k = np.arange(8)
    if layer == 0:
        ks = np.arange(2 * -(-c_dim // 16))[:, None]
        f = 16 * (ks // 2) + 4 * (k % 4) + 2 * (ks % 2) + k // 4
        return np.where(f < c_dim, f, -1)
    ks = np.arange(len(prev_columns) // 8)[:, None]
    return prev_columns[8 * ks + 2 * (k % 4) + k // 4]


def _coupling_index(dims, c_dim):
    """The gather index of one coupling's pack into its source row [0,
    W_0.flatten(), b_0, W_1.flatten(), b_1, ...] (index 0: zero), its layers
    laid out as `_layer_shapes` gives them.  A layer's block: the B
    fragments [k-step][n-tile pair][lane][4] with lane = 4g + t holding
    (B[t][g], B[t + 4][g]) of the pair's two n-tiles, B[k][n] = W[output of
    column 8·nt + n][input behind k]; then the bias by packed column; the
    first layer then x0's weight column (input c_dim) by packed column."""
    parts, src, prev = [], 1, None
    lane = np.arange(32)
    g, t = lane // 4, lane % 4
    for li in range(len(dims) - 1):
        n_in, n_out = dims[li], dims[li + 1]
        cols = _output_columns(n_out, li == len(dims) - 2)
        feats = _input_features(li, c_dim, prev)
        nks, nnt = feats.shape[0], len(cols) // 8
        ks = np.arange(nks)[:, None, None, None]
        pair = np.arange(nnt // 2)[None, :, None, None]
        e = np.arange(4)[None, None, None, :]
        o = cols[8 * (2 * pair + e // 2) + g[None, None, :, None]]
        i = feats[ks, t[None, None, :, None] + 4 * (e % 2)]
        b_frag = np.where((o >= 0) & (i >= 0), src + o * n_in + i, 0)
        bias = np.where(cols >= 0, src + n_out * n_in + cols, 0)
        block = [b_frag.reshape(-1), bias]
        if li == 0:
            block.append(np.where(cols >= 0, src + cols * n_in + c_dim, 0))
        parts.append(np.concatenate(block))
        src += n_out * n_in + n_out
        prev = cols
    return np.concatenate(parts)


def _layer_shapes(dims, c_dim):
    """Per layer of one coupling's pack, (floats, k-steps, n-tiles):
    k-steps × n-tiles × 64 fragment floats and the bias by packed column
    (hidden layers padded to a multiple of 16 columns, the last to 64), the
    first layer also x0's column; its k-steps take the contexts 16 a pair,
    a later layer's the previous layer's packed columns 8 a step."""
    shapes = []
    for li in range(len(dims) - 1):
        cols = 64 if li == len(dims) - 2 else _round_up(dims[li + 1], 16)
        nks = 2 * -(-c_dim // 16) if li == 0 else _round_up(dims[li], 16) // 8
        shapes.append((nks * cols * 8 + cols * (2 if li == 0 else 1), nks, cols // 8))
    return shapes


def _coupling_dims(coupling, c, c_dim):
    ws = coupling.hypernet.weights
    if len(ws) > MAX_LAYERS:
        raise ValueError(f"at most {MAX_LAYERS} hypernet layers are supported, got {len(ws)}")
    dims = [ws[0].shape[2]] + [w.shape[1] for w in ws]
    if dims[0] != c_dim + 1:
        raise ValueError(f"coupling {c} takes {dims[0] - 1} context features, the contexts have {c_dim}")
    if max(dims[1:-1]) > MAX_WIDTH:
        raise ValueError(f"hidden widths above {MAX_WIDTH} are not supported: {dims[1:-1]}")
    if dims[-1] != 2 * (4 * COUNT_BINS - 1):
        raise ValueError(f"the hypernet's output width must be {2 * (4 * COUNT_BINS - 1)}, got {dims[-1]}")
    return dims


def _layout(flow: ConditionalFlow, c_dim: int):
    """Each coupling's hypernet dims and per layer (offset, floats, k-steps,
    n-tiles) of its pack, and the floats of the largest coupling's pack;
    raises ValueError on a structure, a count or a width the kernel does not
    take, or a level whose packs and scratch overflow a block's shared
    memory (as csrc/flow_level.cu sizes it at launch)."""
    if not _matches_kernel(flow):
        raise ValueError("the flow does not match the fused level kernel (see supports_flow)")
    blocks, _ = _plan(flow)
    if len(blocks) > MAX_COUPLINGS:
        raise ValueError(f"at most {MAX_COUPLINGS} couplings are supported, got {len(blocks)}")
    if not 0 < c_dim <= MAX_WIDTH:
        raise ValueError(f"the context width must lie in [1, {MAX_WIDTH}], got {c_dim}")
    couplings = []
    for c, (_, coupling) in enumerate(blocks):
        dims = _coupling_dims(coupling, c, c_dim)
        layers, off = [], 0
        for n, nks, nnt in _layer_shapes(dims, c_dim):
            layers.append((off, n, nks, nnt))
            off += n
        couplings.append((dims, layers))
    floats = max(layers[-1][0] + layers[-1][1] for _, layers in couplings)
    smem = 4 * (len(blocks) * floats + WARPS * SCRATCH_FLOATS)
    if smem > MAX_SHARED_BYTES:
        raise ValueError(f"the level needs {smem} B of shared memory per block, more than {MAX_SHARED_BYTES}")
    return couplings, floats


def level_params(flow: ConditionalFlow, c_dim: int, device) -> _Params:
    """The kernel's parameter block for `flow` with context width c_dim
    (without the pack's address); raises where `_layout` does, or on a
    hypernet tensor off `device`."""
    couplings, floats = _layout(flow, c_dim)
    blocks, radius = _plan(flow)
    prm = _Params()
    num_parts = flow.transforms[1].hypernet.weights[0].shape[0]
    max_tiles = 0
    for c, ((perm, coupling), (dims, layers)) in enumerate(zip(blocks, couplings)):
        for li, (w, b) in enumerate(zip(coupling.hypernet.weights, coupling.hypernet.biases)):
            _check_tensor(f"coupling {c} weight {li}", w, device, (num_parts, dims[li + 1], dims[li]))
            _check_tensor(f"coupling {c} bias {li}", b, device, (num_parts, dims[li + 1]))
        for li, (off, n, nks, nnt) in enumerate(layers):
            prm.layer_off[c][li], prm.layer_floats[c][li] = off, n
            prm.k_steps[c][li], prm.n_tiles[c][li] = nks, nnt
            max_tiles = max(max_tiles, nnt)
        for k in range(3):
            prm.perm[c][k] = perm[k]
        prm.bound[c] = coupling.bound
        prm.n_layers[c] = len(dims) - 1
    prm.n_couplings = len(blocks)
    prm.num_parts = num_parts
    prm.coupling_floats = floats
    prm.c_dim = c_dim
    prm.max_tiles = 8 if max_tiles <= 8 else 16
    prm.radius = 0.0 if radius is None else radius
    return prm


@torch.no_grad()
def level_pack(flow: ConditionalFlow, c_dim: int) -> torch.Tensor:
    """(num_parts, couplings, coupling floats) float32 on the weights'
    device: each part's hypernet in the kernel's fragment order (see
    _coupling_index), each coupling zero-padded to the largest."""
    blocks, _ = _plan(flow)
    ws0 = blocks[0][1].hypernet.weights[0]
    packs = []
    for c, (_, coupling) in enumerate(blocks):
        idx = _coupling_index(_coupling_dims(coupling, c, c_dim), c_dim)
        src = torch.cat([ws0.new_zeros((ws0.shape[0], 1))]
                        + [t.reshape(t.shape[0], -1) for w, b in zip(coupling.hypernet.weights,
                                                                     coupling.hypernet.biases) for t in (w, b)], 1)
        packs.append(src[:, torch.as_tensor(idx, device=src.device)])
    floats = max(p.shape[1] for p in packs)
    return torch.stack([torch.nn.functional.pad(p, (0, floats - p.shape[1])) for p in packs], 1).contiguous()


def _library() -> ctypes.CDLL:
    lib = load_library("flow_level")
    if not getattr(lib, "_bound", False):
        lib.flow_level_params_size.argtypes = []
        lib.flow_level_params_size.restype = ctypes.c_int
        if lib.flow_level_params_size() != ctypes.sizeof(_Params):
            raise RuntimeError("FlowLevelParams differs between csrc/flow_level.cu and its ctypes mirror")
        lib.flow_level_launch.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        lib.flow_level_launch.restype = ctypes.c_int
        lib._bound = True
    return lib


_PLANS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()  # flow → {(c_dim, device): (key, _Params, pack)}


def _cache_key(flow: ConditionalFlow) -> tuple:
    """Each hypernet tensor's address, shape and version: a pack made before
    an in-place write (load_state_dict copies into the same storage) is
    stale."""
    return tuple((t.data_ptr(), tuple(t.shape), t._version) for m in flow.transforms if hasattr(m, "hypernet")
                 for t in (*m.hypernet.weights, *m.hypernet.biases))


def pack_state(flow: ConditionalFlow) -> tuple:
    """What a CUDA graph whose K5 launches read `flow`'s packs must know of
    them: (the pack key, which changes when a cached pack goes stale, the
    flow's cached packs, which the graph keeps alive, as its launches read
    their addresses)."""
    return _cache_key(flow), list(_PLANS.get(flow, {}).values())


def _cached_plan(flow: ConditionalFlow, c_dim: int, device) -> _Params:
    """level_params with the pack's address; built once per flow, context
    width and device, and again when a hypernet tensor moves, changes shape
    or is written."""
    key = _cache_key(flow)
    plans = _PLANS.setdefault(flow, {})
    hit = plans.get((c_dim, device))
    if hit is None or hit[0] != key:
        prm = level_params(flow, c_dim, device)
        pack = level_pack(flow, c_dim)
        prm.packed = pack.data_ptr()
        hit = plans[(c_dim, device)] = (key, prm, pack)
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
    if torch.is_grad_enabled():
        refuse_grad("K5 (flow_level)", z, ctx, *flow.parameters())
    rows = math.prod(lead)
    out = torch.empty_like(z)
    if rows == 0 or p == 0:
        return out
    stream = torch.cuda.current_stream(device).cuda_stream
    ctx_vec = c_dim % 4 == 0 and ctx.data_ptr() % 16 == 0
    rc = _library().flow_level_launch(z.data_ptr(), ctx.data_ptr(), parts.data_ptr(), out.data_ptr(), rows, p,
                                      int(ctx_vec), ctypes.byref(prm), stream)
    if rc != 0:
        raise RuntimeError(f"flow_level_launch failed with CUDA error {rc}")
    if not torch.cuda.is_current_stream_capturing():
        LAUNCHES["flow_level"] += 1
    return out
