"""Operations of one HuManiFlow prediction, counted from the configuration's
shapes (never from the program's modules), two per multiply-add:

* the ResNet encoder's convolutions (2·(in/groups)·k²·out per output
  pixel) and the heads (fc1, shape, global rotation, camera: 2·in·out a
  image);
* per row of the (B, N+1) pass (sample 0 the point estimate): the
  input-shape-glob-cam layer, and per body part its context layer, each
  transform's hypernet (2·in·out + 2·out a layer), its splines (SPLINE_OPS
  each, two a transform) and the radial tanh (RADIAL_OPS);
* SMPL's 951 FMAs per (row, vertex) at the point estimate's, the T-pose's
  and every sample's rows.

Left out: Canny, the heatmaps, BatchNorm, pooling, so3_exp, the variance
and every other elementwise operation; they are a small share and bound by
memory, not counted against the arithmetic peak.
"""

from .k2_fwd import fmas_per_row_vertex

SPLINE_OPS = 190  # one linear-rational spline evaluation, as counted for K5
RADIAL_OPS = 12
PARTS = 23
MAX_ANCESTORS = 7


def conv_out(size: int, k: int, stride: int) -> int:
    return (size + 2 * (k // 2) - k) // stride + 1


def encoder_flops(model_cfg: dict, img: int) -> int:
    """ResNet-18 (BasicBlocks) on a (C, img, img) proxy."""
    assert model_cfg["NUM_RESNET_LAYERS"] == 18
    flops = 0
    s = conv_out(img, 7, 2)
    flops += 2 * model_cfg["NUM_IN_CHANNELS"] * 49 * 64 * s * s
    s = conv_out(s, 3, 2)  # max pool
    in_ch = 64
    for i in range(4):
        f = 64 * 2 ** i
        for j in range(2):
            stride = 2 if i > 0 and j == 0 else 1
            o = conv_out(s, 3, stride)
            flops += 2 * in_ch * 9 * f * o * o + 2 * f * 9 * f * o * o
            if stride != 1 or in_ch != f:
                flops += 2 * in_ch * f * o * o
            s, in_ch = o, f
    nb = model_cfg["NUM_SMPL_BETAS"]
    flops += 2 * (in_ch * 512 + 512 * 2 * nb + 512 * 6 + 512 * 3)
    return flops


def flow_row_flops(model_cfg: dict) -> int:
    """One row (image, sample) of the autoregressive pass over all parts."""
    flow, isgc, nb = model_cfg["NORM_FLOW"], model_cfg["INPUT_SHAPE_GLOB_CAM_FEATS_DIM"], model_cfg["NUM_SMPL_BETAS"]
    ctx, k = flow["CONTEXT_DIM"], flow["NUM_SPLINE_SEGMENTS"]
    flops = 2 * (512 + nb + 9 + 3) * isgc
    per_part = 2 * (isgc + 9 * MAX_ANCESTORS) * ctx + RADIAL_OPS
    dims = [1 + ctx] + list(flow["TRANSFORM_NN_HIDDEN_DIMS"]) + [6 * k + 2 * (k - 1)]
    for _ in range(flow["NUM_TRANSFORMS"]):
        per_part += sum(2 * a * b + 2 * b for a, b in zip(dims[:-1], dims[1:])) + 2 * SPLINE_OPS
    return flops + PARTS * per_part


def smpl_flops(rows: int, smpl_cfg: dict) -> int:
    return rows * smpl_cfg["NUM_VERTS"] * 2 * fmas_per_row_vertex(smpl_cfg["NUM_BETAS"])


def predict_flops(config: dict, b: int, n: int) -> int:
    """A batch of B images at N samples: encoder and heads, the (B, N+1) flow
    pass, SMPL at B + B + B·N rows (point estimate, T-pose, samples)."""
    model = config["MODEL"]
    return (b * encoder_flops(model, config["DATA"]["PROXY_REP_SIZE"]) + b * (n + 1) * flow_row_flops(model)
            + smpl_flops(b * (n + 2), config["SMPL"]))


def flow_part_density_flops(model_cfg: dict) -> int:
    """One (row, part, preimage) of the log-density: each transform's
    hypernet and spline inverses and the radial tanh's inverse."""
    flow, ctx, k = model_cfg["NORM_FLOW"], model_cfg["NORM_FLOW"]["CONTEXT_DIM"], model_cfg["NORM_FLOW"]["NUM_SPLINE_SEGMENTS"]
    dims = [1 + ctx] + list(flow["TRANSFORM_NN_HIDDEN_DIMS"]) + [6 * k + 2 * (k - 1)]
    per = RADIAL_OPS
    for _ in range(flow["NUM_TRANSFORMS"]):
        per += sum(2 * a * b + 2 * b for a, b in zip(dims[:-1], dims[1:])) + 2 * SPLINE_OPS
    return per


def train_step_flops(config: dict, b: int) -> int:
    """A training step at B images: the synthetic batch's SMPL at B rows,
    then the forward (encoder and heads, the (B, N+1) pass at N =
    NUM_J2D_SAMPLES, SMPL at B·(N+1) rows for the 2D joints, the
    teacher-forced contexts of 23 parts and their log-density over three
    preimages) counted three times, for the forward and a backward of twice
    its cost.  The synthetic batch's render, crops, augmentations, Canny and
    heatmaps are left out with the other elementwise work."""
    model = config["MODEL"]
    n = config["LOSS"]["NUM_J2D_SAMPLES"]
    isgc, ctx = model["INPUT_SHAPE_GLOB_CAM_FEATS_DIM"], model["NORM_FLOW"]["CONTEXT_DIM"]
    density = 2 * (512 + model["NUM_SMPL_BETAS"] + 12) * isgc + PARTS * (
        2 * (isgc + 9 * MAX_ANCESTORS) * ctx + 3 * flow_part_density_flops(model))
    forward = (b * encoder_flops(model, config["DATA"]["PROXY_REP_SIZE"]) + b * (n + 1) * flow_row_flops(model)
               + b * density + smpl_flops(b * (n + 1), config["SMPL"]))
    return smpl_flops(b, config["SMPL"]) + 3 * forward
