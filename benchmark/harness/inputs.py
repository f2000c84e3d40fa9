"""Everything a run feeds the program and the reference, made from --seed.

* The body model: the `synthetic_smpl` recipe frozen here (SMPL's widths and
  joint layout; at 6,890 vertices the template is a smooth ellipsoid
  embedding of the DensePose connectivity in model_files/UV_Processed.mat),
  since the licensed SMPL files are not in the repository.
* Weights, drawn on the device from one generator in two large calls (one
  normal, one uniform buffer) and cut into tensors keyed as the checkpoints
  are, from the layouts `humaniflow_spec` and `hrnet_spec` list from the
  configuration's widths.
* Images, keypoints, boxes and the flow's base noise, on the device.
"""

import math
import os
from functools import lru_cache

import numpy as np
import torch

# the DensePose connectivity, static data of the repository
UV_MAT = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
                      "model_files", "UV_Processed.mat")
EXTRA_VERTEX_IDS = (332, 6260, 2800, 4071, 583, 3216, 3226, 3387, 6617, 6624, 6787,
                    2746, 2319, 2445, 2556, 2673, 6191, 5782, 5905, 6016, 6133)


# ------------------------------------------------------------- body model
@lru_cache(maxsize=1)
def _densepose_edges():
    from scipy.io import loadmat

    m = loadmat(UV_MAT)
    faces = np.asarray(m["All_Faces"], np.int64) - 1
    vertex_map = np.asarray(m["All_vertices"], np.int64)[0] - 1
    tri = vertex_map[faces]
    e0 = np.concatenate([tri[:, 0], tri[:, 1], tri[:, 2], tri[:, 1], tri[:, 2], tri[:, 0]])
    e1 = np.concatenate([tri[:, 1], tri[:, 2], tri[:, 0], tri[:, 0], tri[:, 1], tri[:, 2]])
    return e0, e1


def _coherent_vertices(v, rng):
    if v != 6890:
        return None
    e0, e1 = _densepose_edges()
    deg = np.maximum(np.bincount(e0, minlength=v).astype(np.float64), 1.0)[:, None]
    pos = rng.normal(size=(v, 3))
    for _ in range(80):
        g = pos[e1]
        pos = np.stack([np.bincount(e0, weights=g[:, c], minlength=v) for c in range(3)], axis=1) / deg
        pos -= pos.mean(0)
        pos /= np.maximum(np.linalg.norm(pos, axis=1, keepdims=True), 1e-9)
    return pos * np.array([0.35, 0.75, 0.25])


def _convex_rows(rng, rows, cols):
    w = np.exp(rng.normal(scale=2.0, size=(rows, cols)))
    return w / w.sum(axis=1, keepdims=True)


def body_model(num_verts: int, num_betas: int, seed: int) -> dict:
    """The SMPL-structured arrays (numpy; floats float32, indices int64)."""
    rng = np.random.default_rng(seed)
    v = num_verts
    joints = rng.normal(scale=0.3, size=(24, 3))
    verts = _coherent_vertices(v, rng)
    if verts is None:
        verts = joints[rng.integers(0, 24, v)] + rng.normal(scale=0.05, size=(v, 3))
    else:
        joints = verts[rng.integers(0, v, 24)] * 0.6
    w = np.exp(-((verts[:, None] - joints[None]) ** 2).sum(-1) / 0.01)
    f32 = np.float32
    return {
        "v_template": verts.astype(f32),
        "shapedirs": rng.normal(scale=0.01, size=(v, 3, num_betas)).astype(f32),
        "posedirs": rng.normal(scale=0.001, size=(23 * 9, v * 3)).astype(f32),
        "j_regressor": (w / w.sum(0, keepdims=True)).T.astype(f32),
        "lbs_weights": (w / w.sum(1, keepdims=True)).astype(f32),
        "faces": rng.integers(0, v, size=(2 * v, 3)),
        "extra_joint_vertex_ids": np.array(EXTRA_VERTEX_IDS, np.int64) % v,
        "j_regressor_extra": _convex_rows(rng, 9, v).astype(f32),
        "j_regressor_cocoplus": _convex_rows(rng, 19, v).astype(f32),
        "j_regressor_h36m": _convex_rows(rng, 17, v).astype(f32),
    }


def body_model_on(arrays: dict, device) -> dict:
    return {k: torch.as_tensor(a, device=device) for k, a in arrays.items()}


# ------------------------------------------------------------------ weights
# init kinds: ("normal", std), ("uniform", lo, hi), ("const", value)
def _conv(spec, name, out_ch, in_ch, k, gain=1.0):
    spec.append((f"{name}.weight", (out_ch, in_ch, k, k), ("normal", gain / math.sqrt(in_ch * k * k))))


def _bn(spec, name, c, randomised):
    if randomised:
        spec += [(f"{name}.weight", (c,), ("uniform", 0.8, 1.2)), (f"{name}.bias", (c,), ("normal", 0.1)),
                 (f"{name}.running_mean", (c,), ("normal", 0.1)),
                 (f"{name}.running_var", (c,), ("uniform", 0.8, 1.2))]
    else:
        spec += [(f"{name}.weight", (c,), ("const", 1.0)), (f"{name}.bias", (c,), ("const", 0.0)),
                 (f"{name}.running_mean", (c,), ("const", 0.0)), (f"{name}.running_var", (c,), ("const", 1.0))]
    spec.append((f"{name}.num_batches_tracked", (), ("const", 0)))


def _dense(spec, name, out_f, in_f, parts=None):
    lead = () if parts is None else (parts,)
    bound = 1.0 / math.sqrt(in_f)
    spec += [(f"{name}.weight" if parts is None else f"{name}_weight", lead + (out_f, in_f), ("uniform", -bound, bound)),
             (f"{name}.bias" if parts is None else f"{name}_bias", lead + (out_f,), ("uniform", -bound, bound))]


def humaniflow_spec(model_cfg: dict) -> list:
    """(key, shape, init) of every tensor of the HuManiFlow checkpoint at the
    configuration's widths: LeCun-normal convolutions, U(±1/√fan_in) dense
    layers, BatchNorm with drawn scales and running statistics."""
    assert model_cfg["NUM_RESNET_LAYERS"] == 18, "the spec lists ResNet-18's BasicBlocks"
    spec = []
    _conv(spec, "encoder.conv1", 64, model_cfg["NUM_IN_CHANNELS"], 7)
    _bn(spec, "encoder.bn1", 64, True)
    in_ch = 64
    for i in range(4):
        f = 64 * 2 ** i
        for j in range(2):
            p = f"encoder.blocks.layer{i + 1}_block{j}"
            stride = 2 if i > 0 and j == 0 else 1
            _conv(spec, f"{p}.conv1", f, in_ch, 3)
            _bn(spec, f"{p}.bn1", f, True)
            _conv(spec, f"{p}.conv2", f, f, 3)
            _bn(spec, f"{p}.bn2", f, True)
            if stride != 1 or in_ch != f:
                _conv(spec, f"{p}.downsample_conv", f, in_ch, 1)
                _bn(spec, f"{p}.downsample_bn", f, True)
            in_ch = f
    nb, isgc, flow = model_cfg["NUM_SMPL_BETAS"], model_cfg["INPUT_SHAPE_GLOB_CAM_FEATS_DIM"], model_cfg["NORM_FLOW"]
    feat = in_ch
    _dense(spec, "fc1", 512, feat)
    _dense(spec, "fc_shape", 2 * nb, 512)
    _dense(spec, "fc_glob", 6, 512)
    _dense(spec, "fc_cam", 3, 512)
    _dense(spec, "fc_isgc", isgc, feat + nb + 9 + 3)
    ctx = flow["CONTEXT_DIM"]
    _dense(spec, "fc_flow_context", ctx, isgc + 9 * 7, parts=23)  # 7: the deepest part's ancestors
    k = flow["NUM_SPLINE_SEGMENTS"]
    dims = [1 + ctx] + list(flow["TRANSFORM_NN_HIDDEN_DIMS"]) + [2 * k * 3 + 2 * (k - 1)]
    for i in range(flow["NUM_TRANSFORMS"]):
        t = f"flow.transforms.{2 * i + 1}.hypernet"
        for layer in range(len(dims) - 1):
            bound = 1.0 / math.sqrt(dims[layer])
            spec += [(f"{t}.weights.{layer}", (23, dims[layer + 1], dims[layer]), ("uniform", -bound, bound)),
                     (f"{t}.biases.{layer}", (23, dims[layer + 1]), ("uniform", -bound, bound))]
    return spec


def hrnet_spec(hrnet_cfg: dict) -> list:
    """(key, shape, init) of the HRNet-W48 checkpoint: LeCun-normal
    convolutions ×CONV_GAIN, identity BatchNorm and a final bias of
    FINAL_BIAS.  At a gain of 0.7 and no bias the heatmaps are of order 1 and
    about half the keypoints clear the proxy's 0.75 visibility threshold; at
    0.25 with a bias of 1 the activations die out over the stages and the
    bf16 heatmaps are a constant 1."""
    c, gain = hrnet_cfg["STAGE_CHANNELS"], hrnet_cfg["CONV_GAIN"]
    spec = []
    conv = lambda name, o, i, k: _conv(spec, name, o, i, k, gain)  # noqa: E731
    bn = lambda name, ch: _bn(spec, name, ch, False)  # noqa: E731
    conv("conv1", 64, 3, 3)
    bn("bn1", 64)
    conv("conv2", 64, 64, 3)
    bn("bn2", 64)
    for k in range(4):
        p, in_ch = f"layer1_block{k}", 64 if k == 0 else 256
        conv(f"{p}.conv1", 64, in_ch, 1)
        bn(f"{p}.bn1", 64)
        conv(f"{p}.conv2", 64, 64, 3)
        bn(f"{p}.bn2", 64)
        conv(f"{p}.conv3", 256, 64, 1)
        bn(f"{p}.bn3", 256)
        if in_ch != 256:
            conv(f"{p}.downsample_conv", 256, in_ch, 1)
            bn(f"{p}.downsample_bn", 256)
    for name, o, i in (("transition1_0", c[0], 256), ("transition1_1", c[1], 256),
                       ("transition2_2", c[2], c[1]), ("transition3_3", c[3], c[2])):
        conv(f"{name}_conv", o, i, 3)
        bn(f"{name}_bn", o)
    for s, n_modules in zip((2, 3, 4), hrnet_cfg["STAGE_MODULES"]):
        for m in range(n_modules):
            p = f"stage{s}_module{m}"
            for b in range(s):
                for k in range(hrnet_cfg["STAGE_BLOCKS"]):
                    for j in (1, 2):
                        conv(f"{p}.branch{b}_block{k}.conv{j}", c[b], c[b], 3)
                        bn(f"{p}.branch{b}_block{k}.bn{j}", c[b])
            for i in range(1 if (s == 4 and m == n_modules - 1) else s):
                for j in range(s):
                    if j > i:
                        conv(f"{p}.fuse{i}_{j}_conv", c[i], c[j], 1)
                        bn(f"{p}.fuse{i}_{j}_bn", c[i])
                    for k in range(i - j if j < i else 0):
                        out = c[i] if k == i - j - 1 else c[j]
                        conv(f"{p}.fuse{i}_{j}_conv{k}", out, c[j], 3)
                        bn(f"{p}.fuse{i}_{j}_bn{k}", out)
    conv("final_layer", hrnet_cfg["NUM_JOINTS"], c[0], 1)
    spec.append(("final_layer.bias", (hrnet_cfg["NUM_JOINTS"],), ("const", hrnet_cfg["FINAL_BIAS"])))
    return spec


def draw_weights(spec: list, generator: torch.Generator, device) -> dict:
    """Tensors for `spec`, cut from one normal and one uniform buffer drawn
    on `device` (float32; BatchNorm's counters int64)."""
    sizes = {"normal": 0, "uniform": 0}
    for _, shape, init in spec:
        if init[0] in sizes:
            sizes[init[0]] += math.prod(shape)
    bufs = {"normal": torch.randn(sizes["normal"], generator=generator, device=device),
            "uniform": torch.rand(sizes["uniform"], generator=generator, device=device)}
    at = {"normal": 0, "uniform": 0}
    out = {}
    for key, shape, init in spec:
        kind = init[0]
        if kind == "const":
            dtype = torch.int64 if key.endswith("num_batches_tracked") else torch.float32
            out[key] = torch.full(shape, init[1], dtype=dtype, device=device)
            continue
        n = math.prod(shape)
        raw = bufs[kind][at[kind]:at[kind] + n].reshape(shape)
        at[kind] += n
        out[key] = raw * init[1] if kind == "normal" else init[1] + (init[2] - init[1]) * raw
    return out


# ------------------------------------------------------------ traffic data
def crop_batch(b: int, img: int, generator, device):
    """(images (B, img, img, 3) in [0, 1], joints2d (B, 17, 2), confs (B, 17)):
    a bright upright blob on a noisy background, keypoints uniform in the
    middle half, confidences in [0.5, 1]."""
    yy, xx = torch.meshgrid(torch.arange(img, device=device) / img, torch.arange(img, device=device) / img,
                            indexing="ij")
    body = torch.exp(-(((xx - 0.5) / 0.15) ** 2 + ((yy - 0.5) / 0.35) ** 2))
    noise = torch.randn((b, img, img, 3), generator=generator, device=device)
    images = torch.clamp(0.2 + 0.6 * body[None, ..., None] + 0.05 * noise, 0.0, 1.0)
    joints2d = img * (0.25 + 0.5 * torch.rand((b, 17, 2), generator=generator, device=device))
    confs = 0.5 + 0.5 * torch.rand((b, 17), generator=generator, device=device)
    return images, joints2d, confs


def uncropped_photo(h: int, w: int, generator, device):
    """One (h, w, 3) photo in [0, 1] with a bright upright person-sized blob
    off the centre, and the person box (centre (y, x), height, width) a
    detector would give."""
    u = torch.rand(2, generator=generator, device=device)
    cy, cx = float(0.35 + 0.3 * u[0]) * h, float(0.3 + 0.4 * u[1]) * w
    yy, xx = torch.meshgrid(torch.arange(h, device=device, dtype=torch.float32),
                            torch.arange(w, device=device, dtype=torch.float32), indexing="ij")
    body = torch.exp(-(((xx - cx) / (0.08 * w)) ** 2 + ((yy - cy) / (0.3 * h)) ** 2))
    img = 0.15 + 0.6 * body[..., None] + 0.05 * torch.randn((h, w, 3), generator=generator, device=device)
    return torch.clamp(img, 0.0, 1.0), ((cy, cx), 0.75 * h, 0.4 * w)


def level_noise(b: int, n: int, level_sizes, generator, device):
    """The flow's base noise: per kinematic level (B, N, P, 3) standard normal."""
    return [torch.randn((b, n, p, 3), generator=generator, device=device) for p in level_sizes]


def synth_inputs(b: int, size: int, pose_std: float, texture_hw, generator, device) -> dict:
    """One batch of the synthetic-data function's inputs: SMPL poses (B, 72)
    N(0, pose_std²) per axis-angle component, texture atlases (B, TH, TW, 3)
    and size² backgrounds (B, size, size, 3), uniform in [0, 1]."""
    th, tw = texture_hw
    return {"pose": pose_std * torch.randn((b, 72), generator=generator, device=device),
            "texture": torch.rand((b, th, tw, 3), generator=generator, device=device),
            "background": torch.rand((b, size, size, 3), generator=generator, device=device)}
