"""Where the time of distribution inference, evaluation and training goes on
the card.

    python -m humaniflow_torch.utils.profiling [--batch 32] [--samples 100] [--fused-level]
    python -m humaniflow_torch.utils.profiling --protocol ssp3d|3dpw [--batch 32] [--fused-level]
    python -m humaniflow_torch.utils.profiling --train [--batch 72]
    python -m humaniflow_torch.utils.profiling --compare PARENT_ROOT
    python -m humaniflow_torch.utils.profiling --plans

Builds the default model (seeded random weights) and synthetic SMPL at 6890
vertices.  Without --protocol it prints, for the model forward and for the
whole distribution-inference program (forward → K1 moments → variance, plus
the K2 point estimate):

* wall ms per batch (host clock around work ending in a synchronise),
  taken for both programs before the first profiler session, which leaves
  the host slower for the rest of the process;
* device busy ms per batch (union of kernel intervals in a torch.profiler
  trace) and the idle share, 1 − busy / wall;
* kernel launches per batch and the kernels that take the most device time;
* the forward split into encoder, heads and the autoregressive flow pass
  (CUDA events).

With --protocol it prints the same for one batch of that evaluation
protocol (SSP-3D at N=100 with silhouettes, 3DPW at N=10) on synthetic data
staged on the card: the eval step (proxy, forward, SMPL through K2), the
silhouettes (DensePose gather, projection, K3), the metrics, and the three
together; for SSP-3D also K3 alone on the batch's 3,200 sample meshes.

With --train it prints the same for one synthetic-data batch (the training
renderer: kernel K4, per-face texels, culling) and one train step (forward,
backward through K2's gradient, Adam) at the default training config, with
poses, textures and backgrounds staged on the card.

With --compare it times kernels K6, K4 (the training batch), K2's forward
(at the paths' five row counts), K1, K2's backward kernel, K5 (the 8
levels of one AR pass at 3,232 rows, summed) and K7 (3,200 rows) of another
checkout (PARENT_ROOT, e.g. the parent commit unpacked with `git archive`
into a directory that .gitignore lists) and of this one, in turns on one
card, on the same inputs: CUDA-event ms per call and the kernels' device ms
per call (torch.profiler), one JSON line per turn.  With --plans it times K2's
forward at those row counts through each of its row groups, K4 through
tiles of several key budgets and K1 at N = 96, 100 and 112.

--fused-level sets HFT_FUSED_LEVEL=1 for the run, so that the flow pass
goes through the fused level kernel K5; run the script with and without it
to compare the two configurations.

Needs a CUDA device; it exits non-zero without one.  The module also holds
the JAX package's StageTimer, which times named stages of a program.
"""

import argparse
import contextlib
import os
import sys
import time
from collections import defaultdict
from typing import Dict

import numpy as np


def wall_ms(fn, iters):
    """Mean host-clock ms of fn() ending in a device synchronise, after one
    warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / iters


def cuda_ms(fn, iters):
    """Mean ms of fn() between two CUDA events, after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(iters):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / iters


def _synchronize_devices_of(result):
    """Wait for the CUDA devices that hold the tensors of `result` (a tensor
    or nested lists, tuples and dicts of them): the port's
    jax.block_until_ready."""
    import torch

    devices, todo = set(), [result]
    while todo:
        x = todo.pop()
        if isinstance(x, torch.Tensor):
            if x.device.type == "cuda":
                devices.add(x.device)
        elif isinstance(x, dict):
            todo.extend(x.values())
        elif isinstance(x, (list, tuple)):
            todo.extend(x)
    for device in devices:
        torch.cuda.synchronize(device)


class StageTimer:
    """Wall-clock timing of named stages, each ending when the device work
    of its result is done (the counterpart of the JAX package's StageTimer)."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    def _add(self, name: str, seconds: float):
        self.totals[name] += seconds
        self.counts[name] += 1

    @contextlib.contextmanager
    def stage(self, name: str, sync_result=None):
        """Time the block; with sync_result, wait for its tensors' devices
        before the clock stops."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync_result is not None:
                _synchronize_devices_of(sync_result)
            self._add(name, time.perf_counter() - t0)

    def time_stage(self, name: str, fn, *args, **kwargs):
        """fn(*args, **kwargs), timed until the device work of its result is done."""
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        _synchronize_devices_of(out)
        self._add(name, time.perf_counter() - t0)
        return out

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            name: {
                "total_s": self.totals[name],
                "count": self.counts[name],
                "mean_ms": 1000.0 * self.totals[name] / max(self.counts[name], 1),
            }
            for name in self.totals
        }

    def report(self) -> str:
        lines = ["stage timings:"]
        for name, s in sorted(self.summary().items()):
            lines.append(f"  {name:<32} {s['mean_ms']:9.2f} ms/call × {s['count']:<6d} = {s['total_s']:8.2f} s")
        return "\n".join(lines)


def kernel_device_ms(fn, name: str, iters: int = 20, sessions: int = 3) -> float:
    """Mean device duration (torch.profiler) of the CUDA kernels whose name
    contains `name` per call of fn, after one warm-up call: the kernel's own
    time, without the host time between launches that CUDA events around a
    loop of short launches also count.  A profiler session now and then
    reports no device activity at all (seen on the H100 after many sessions
    in one process); such a session is run again, up to `sessions` times."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(sessions):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        if events:
            break
    us = [e.time_range.elapsed_us() for e in events if name in e.name]
    if not us:
        raise RuntimeError(f"the profiler saw no kernel named like {name!r}")
    return sum(us) / 1e3 / iters


def device_profile(fn, iters: int = 5, top: int = 8) -> dict:
    """Profile `iters` calls of fn (after a warm-up): device busy ms and
    launches per call, and the top kernels by device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    kernels = [
        e for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA and e.time_range.elapsed_us() > 0
    ]
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    busy_ms = busy / 1e3 / iters
    return {
        "device_busy_ms": busy_ms,
        "launches": len(kernels) / iters,
        "top_kernels_ms": [(name[:80], us / 1e3 / iters) for name, us in ranked],
    }


class SyntheticEvalDataset:
    """SSP-3D-shaped synthetic evaluation data in the real datasets' format
    (uint8 image, keypoints, GT pose, shape, 2D joints and silhouette), item
    i made from numpy seed i."""

    def __init__(self, n: int, img: int = 256):
        self.n = n
        self.img = img

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        rng = np.random.default_rng(i)
        img = self.img
        sil = np.zeros((img, img), np.uint8)
        sil[img // 4 : 3 * img // 4, 5 * img // 16 : 11 * img // 16] = 1
        return {
            "pose": rng.normal(scale=0.3, size=72).astype(np.float32),
            "shape": rng.normal(scale=0.5, size=10).astype(np.float32),
            "joints2D": rng.uniform(0, img, size=(17, 2)).astype(np.float32),
            "joints2D_visib": np.ones(17, bool),
            "fname": f"frame_{i:04d}.png",
            "gender": "f" if i % 2 else "m",
            "image": (rng.uniform(size=(img, img, 3)) * 255).astype(np.uint8),
            "input_joints2D": rng.uniform(0, img, size=(17, 2)).astype(np.float32),
            "input_joints2D_vis": np.ones(17, bool),
            "silhouette": sil,
        }


def coverage_cases(device="cuda") -> dict:
    """Seeded inputs that reach every branch of K3 (csrc/coverage.cu):
    {name: (verts_screen (M, V, 3) float32, faces (F, 3) int32, image_size,
    cull_sign)}.  A face over the whole image; a mesh whose faces are all
    culled beside its mirror image, whose faces are all kept; faces across
    the band borders at 1024² (bands of 256 rows) with a NaN vertex and two
    out-of-range indices; image sizes 33 and 200 (a ragged last word of mask
    bits); M = 1 and M = 257; 2,000 slivers, more of whose boxes exceed
    K3's 4,096-pixel threshold than its queue holds.  F is not a multiple
    of 32."""
    import torch

    rng = np.random.default_rng(0)

    def soup(m, f, img, lo, hi, cy=None):
        """m meshes of f faces with 3 vertices each: centres over the image
        and past its borders (rows near cy if given), sizes log-uniform in
        [lo, hi] px."""
        c = rng.uniform(-0.1 * img, 1.1 * img, size=(m, f, 1, 2))
        if cy is not None:
            c[..., 1] = rng.choice(cy, size=(m, f, 1)) + rng.uniform(-30, 30, size=(m, f, 1))
        size = np.exp(rng.uniform(np.log(lo), np.log(hi), size=(m, f, 1, 1)))
        xy = c + size * rng.uniform(-1, 1, size=(m, f, 3, 2))
        verts = np.concatenate([xy, rng.uniform(size=(m, f, 3, 1))], -1).reshape(m, 3 * f, 3)
        return verts, np.arange(3 * f).reshape(f, 3)

    cases = {}
    whole = np.array([[[-5.0, -5.0, 0], [768.0, -5.0, 0], [-5.0, 768.0, 0], [10.2, 20.7, 0], [30.4, 12.1, 0],
                       [22.9, 40.3, 0]]])
    cases["whole-image face"] = (whole, np.arange(6).reshape(2, 3), 256, 0)
    v, faces = soup(1, 45, 256, 2, 40)
    x, y = v[0, :, 0].reshape(-1, 3), v[0, :, 1].reshape(-1, 3)
    area = (x[:, 1] - x[:, 0]) * (y[:, 2] - y[:, 0]) - (x[:, 2] - x[:, 0]) * (y[:, 1] - y[:, 0])
    faces[area > 0] = faces[area > 0][:, [0, 2, 1]]  # every face wound negatively: culled by cull_sign 1
    mirror = v.copy()
    mirror[..., 0] = 256 - mirror[..., 0]  # the mirror image: every face wound positively
    cases["all culled, and its mirror all kept"] = (np.concatenate([v, mirror]), faces, 256, 1)
    v, faces = soup(3, 301, 1024, 2, 300, cy=np.array([256.0, 512.0, 768.0]))
    v[0, 17, 1] = np.nan
    faces = np.concatenate([faces, [[0, 1, v.shape[1]], [-1, 2, 3]]])
    cases["band borders at 1024², NaN vertex, 2 indices out of range"] = (v, faces, 1024, 0)
    cases["33², ragged word"] = (*soup(3, 45, 33, 0.5, 40), 33, 1)
    cases["200², ragged word"] = (*soup(3, 45, 200, 1, 150), 200, 0)
    cases["M=1"] = (*soup(1, 77, 256, 1, 100), 256, -1)
    cases["M=257"] = (*soup(257, 45, 256, 1, 60), 256, 1)
    # slivers: long thin faces, so that their boxes are large and cover little
    p0 = rng.uniform(-20, 276, size=(2, 2000, 1, 2))
    ang = rng.uniform(0, 2 * np.pi, size=(2, 2000, 1))
    d = np.stack([np.cos(ang), np.sin(ang)], -1) * rng.uniform(50, 250, size=(2, 2000, 1, 1))
    n = np.stack([-np.sin(ang), np.cos(ang)], -1) * rng.uniform(0.3, 2.0, size=(2, 2000, 1, 1))
    xy = np.concatenate([p0, p0 + d, p0 + 0.5 * d + n], axis=2)
    v = np.concatenate([xy, np.zeros((2, 2000, 3, 1))], -1).reshape(2, 6000, 3)
    cases["2,000 large boxes"] = (v, np.arange(6000).reshape(2000, 3), 256, 0)
    return {
        name: (torch.tensor(v, dtype=torch.float32, device=device),
               torch.tensor(np.asarray(f), dtype=torch.int32, device=device), img, cull)
        for name, (v, f, img, cull) in cases.items()
    }


def sliver_case(img: int, device="cuda", seed: int = 0):
    """Near-degenerate faces for K6's cull (csrc/tiled_raster.cu): two
    meshes (the second the first with x and y swapped) of 2,400 faces with
    three vertices each and random depths, (verts_screen (2, 7200, 3)
    float32, faces (2400, 3) int32).  Six families of 400: slivers lying on
    lines of slope ±1 and of slopes 1/4 to 3 through pixel centres, their
    third vertex 1e-5 px off the line (the rounding of their edge functions
    claims centres beyond their tips, outside their boxes); needles (two
    vertices within 1e-3 px); faces whose float32 area lies just above the
    1e-9 validity threshold; random slivers 1e-7 to 1e-2 px thick; and
    ordinary faces over them, so that the depth test has work to do."""
    import torch

    rng = np.random.default_rng(seed)
    k, lo, hi = 400, 0.1 * img, 0.9 * img

    def centre(n):
        return np.floor(rng.uniform(lo, hi, size=(n, 2))) + 0.5

    def on_line(slope):
        p0 = centre(k)
        length = rng.integers(4, max(5, img // 5), size=(k, 1)).astype(np.float64)
        d = np.concatenate([np.ones((k, 1)), slope[:, None]], -1) * length
        t = rng.uniform(0.2, 0.8, size=(k, 1))
        p2 = p0 + t * d + np.stack([rng.normal(scale=1e-5, size=k), np.zeros(k)], -1)
        return np.stack([p0, p0 + d, p2], 1)

    fam = [on_line(rng.choice([-1.0, 1.0], size=k)), on_line(rng.choice([0.25, 1 / 3, 0.5, 2.0, 3.0], size=k))]
    p0 = centre(k) + rng.uniform(-0.5, 0.5, size=(k, 2))
    fam.append(np.stack([p0, p0 + rng.normal(scale=1e-3, size=(k, 2)), p0 + rng.normal(scale=0.1 * img, size=(k, 2))],
                        1))
    tiny = []
    while len(tiny) < k:  # float32 |area| in (1e-9, 1e-7]
        p = (centre(1) + rng.uniform(-0.5, 0.5, size=(1, 2)) + rng.normal(scale=10 ** rng.uniform(-5, -3),
                                                                          size=(3, 2))).astype(np.float32)
        a = (p[1, 0] - p[0, 0]) * (p[2, 1] - p[0, 1]) - (p[2, 0] - p[0, 0]) * (p[1, 1] - p[0, 1])
        if 1e-9 < abs(float(a)) <= 1e-7:
            tiny.append(p)
    fam.append(np.stack(tiny))
    ang = rng.uniform(0, 2 * np.pi, size=(k, 1))
    d = np.concatenate([np.cos(ang), np.sin(ang)], -1) * rng.uniform(3, 0.3 * img, size=(k, 1))
    nrm = np.concatenate([-np.sin(ang), np.cos(ang)], -1) * 10 ** rng.uniform(-7, -2, size=(k, 1))
    p0 = centre(k) + rng.uniform(-0.5, 0.5, size=(k, 2))
    fam.append(np.stack([p0, p0 + d, p0 + rng.uniform(0.1, 0.9, size=(k, 1)) * d + nrm], 1))
    p0 = centre(k)
    fam.append(p0[:, None] + rng.normal(scale=6.0, size=(k, 3, 2)))
    xy = np.concatenate(fam).astype(np.float32)  # (F, 3, 2)
    f = xy.shape[0]
    z = rng.uniform(size=(f, 3, 1)).astype(np.float32)
    verts = np.concatenate([xy, z], -1).reshape(1, 3 * f, 3)
    verts = np.concatenate([verts, verts[..., [1, 0, 2]]])
    return (torch.tensor(verts, dtype=torch.float32, device=device),
            torch.arange(3 * f, dtype=torch.int32, device=device).reshape(f, 3))


def load_checkout(root: str, name: str):
    """The humaniflow_torch package of the checkout at `root`, imported under
    the module name `name`, so that two versions of the kernels can be timed
    in one process (each builds its sources into its own checkout)."""
    import importlib.util

    init = os.path.join(os.path.abspath(root), "humaniflow_torch", "__init__.py")
    spec = importlib.util.spec_from_file_location(name, init, submodule_search_locations=[os.path.dirname(init)])
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


K2_ROWS = (32, 72, 320, 576, 3200)  # K2's forward rows on the paths
K2_BACKWARD_ROWS = (32, 72, 576)
K5_ROWS = 32 * 101  # one AR pass of distribution inference: B = 32, N + 1 = 101
K7_ROWS = 32 * 100
TRAIN_B = 72  # the training batch: K4's meshes


def training_renderer(device="cuda", img: int = None):
    """The renderer of the synthetic-data batch at the default config
    (pipelines/train.py::make_training_renderer, culled, as run_train's
    default --cull) at img² or the default 256²."""
    import dataclasses

    from ..configs import get_humaniflow_cfg_defaults
    from ..pipelines.train import make_training_renderer

    cfg = get_humaniflow_cfg_defaults()
    if img:
        cfg.DATA = dataclasses.replace(cfg.DATA, PROXY_REP_SIZE=img)
    return make_training_renderer(cfg, cull=True, device=device)


def training_screen(smpl, b: int, seed: int, device="cuda", img: int = None):
    """(training_renderer(device, img), its screen coordinates (b, 7829, 3))
    of b synthetic bodies as the synthetic-data batch renders them: poses
    0.3·N(0, 1), shapes 1.25·N(0, 1), flipped by the x-axis π rotation,
    camera (0, −0.2, 2.5) + 0.05·N(0, 1)."""
    import math

    import torch

    from ..models import smpl_forward
    from ..ops import aa_rotate_rotmats, aa_rotate_translate_points, so3_exp

    renderer = training_renderer(device, img)
    g = torch.Generator(device).manual_seed(seed)
    x_axis = torch.tensor([1.0, 0.0, 0.0], device=device)
    with torch.inference_mode():
        pose = so3_exp(0.3 * torch.randn((b, 24, 3), generator=g, device=device))
        _, glob = aa_rotate_rotmats(pose[:, 0], x_axis, math.pi)
        shape = 1.25 * torch.randn((b, 10), generator=g, device=device)
        verts = smpl_forward(smpl, shape, pose[:, 1:], glob)["vertices"]
        verts = aa_rotate_translate_points(verts, x_axis, math.pi, torch.zeros(3, device=device))
        cam_t = (torch.tensor([0.0, -0.2, 2.5], device=device)
                 + 0.05 * torch.randn((b, 3), generator=g, device=device))
        sv = renderer._screen_verts(verts[:, renderer.dp["vertex_map"]], cam_t).contiguous()
    return renderer, sv


def kernel_timing_inputs(seed: int = 0) -> dict:
    """Inputs at the paths' shapes on the card: K6's 32 posed bodies at 256²
    as the visualisation renders them (tile-sorted DensePose faces), K4's 72
    bodies as the training batch renders them (4 constant planes, culled),
    K2's (B, V = 6890) arguments at K2_ROWS, K1's at (32, 100), cotangents
    for K2's backward, K5's base samples 0.6·N(0, 1) and contexts ELU(N(0,
    1)) for each of the default model's 8 levels at K5_ROWS, and K7's
    arguments at K7_ROWS and V = 6890."""
    import math

    import torch

    from ..configs import get_humaniflow_cfg_defaults
    from ..models import HumaniflowModel, smpl_forward, synthetic_smpl
    from ..models.smpl import _kernel_inputs
    from ..ops import aa_rotate_translate_points, so3_exp
    from ..render import TexturedIUVRenderer
    from ..render.cuda_tiled import tile_sort_order

    g = torch.Generator("cuda").manual_seed(seed)
    smpl = synthetic_smpl(num_verts=6890)
    renderer = TexturedIUVRenderer(img_wh=256, projection_type="orthographic", rasterizer="tiled")
    b = 32
    with torch.inference_mode():
        pose = so3_exp(0.25 * torch.randn((b, 24, 3), generator=g, device="cuda"))
        verts = smpl_forward(smpl, torch.randn((b, 10), generator=g, device="cuda"), pose[:, 1:],
                             pose[:, 0])["vertices"]
        verts = aa_rotate_translate_points(verts, torch.tensor([1.0, 0.0, 0.0], device="cuda"), math.pi,
                                           torch.zeros(3, device="cuda"))
        cam_t = torch.cat([0.05 * (2 * torch.rand((b, 2), generator=g, device="cuda") - 1),
                           torch.full((b, 1), 2.5, device="cuda")], -1)
        sv = renderer._screen_verts(verts[:, renderer.dp["vertex_map"]], cam_t,
                                    torch.full((b, 2), 0.9, device="cuda")).contiguous()
    faces = renderer.dp["faces"]
    out = {"k6": (sv, faces[tile_sort_order(sv[0], faces)].contiguous(), 256)}
    train_renderer, train_sv = training_screen(smpl, TRAIN_B, seed + 42)
    train_faces = train_renderer.dp["faces"]
    attrs = torch.randn((TRAIN_B, train_faces.shape[0], 4), generator=g, device="cuda")
    out["k4"] = ((train_sv, train_faces, train_renderer.img_wh), dict(attrs=attrs, emit_frags=False, cull_sign=1))

    def args(rows):
        betas = torch.randn((rows, 10), generator=g, device="cuda")
        rots = so3_exp(0.4 * torch.randn((rows, 24, 3), generator=g, device="cuda"))
        _, a12, pf = _kernel_inputs(smpl, betas, rots[:, 1:], rots[:, 0])
        return (a12.contiguous(), betas, pf.contiguous(), smpl.v_template_cm, smpl.shapedirs_cm, smpl.posedirs_cm,
                smpl.lbs_weights)

    out["k2"] = {rows: args(rows) for rows in K2_ROWS}
    a = args(32 * 100)
    out["k1"] = tuple(t.reshape(32, 100, *t.shape[1:]) for t in a[:3]) + a[3:]
    out["k2_grad"] = {rows: torch.randn((rows, 3, 6890), generator=g, device="cuda") for rows in K2_BACKWARD_ROWS}
    cfg = get_humaniflow_cfg_defaults()
    levels = HumaniflowModel(cfg.MODEL, device="cpu").levels
    out["k5"] = [(0.6 * torch.randn((K5_ROWS, len(parts), 3), generator=g, device="cuda"),
                  torch.nn.functional.elu(torch.randn((K5_ROWS, len(parts), cfg.MODEL.NORM_FLOW.CONTEXT_DIM),
                                                      generator=g, device="cuda")))
                 for parts in levels]
    out["k7"] = (torch.softmax(3.0 * torch.randn((6890, 24), generator=g, device="cuda"), -1),
                 0.5 * torch.randn((K7_ROWS, 24, 12), generator=g, device="cuda"),
                 torch.randn((K7_ROWS, 3, 6890), generator=g, device="cuda"))
    return out


def time_kernels(pkg, inputs: dict, iters: int = 20, only: str = "") -> dict:
    """{kernel and shape: (CUDA-event ms per call over `iters` calls, device
    ms per call from torch.profiler)} of K6, K4, K2's forward, K1, K2's
    backward kernel, K5 (one AR pass: the 8 levels' launches) and K7
    through the wrappers of package `pkg` (a humaniflow_torch, possibly
    another checkout's from load_checkout), those whose name starts with
    `only`.  K5 runs the flow of `pkg`'s own default model, built from seed
    0, so that each checkout's wrapper sees its own transform classes.  The
    event times include the wrapper's host time between launches; the
    device times are the kernels' own."""
    import importlib

    import torch

    lbs = importlib.import_module(f"{pkg.__name__}.models.cuda_lbs")
    tiled = importlib.import_module(f"{pkg.__name__}.render.cuda_tiled")
    raster = importlib.import_module(f"{pkg.__name__}.render.cuda_raster")
    k4_args, k4_kw = inputs["k4"]
    calls = {"K6 B=32 256²": lambda: tiled.rasterize_tiled(*inputs["k6"]),
             f"K4 B={TRAIN_B} 256²": lambda: raster.raster(*k4_args, **k4_kw)}
    for rows, a in inputs["k2"].items():
        calls[f"K2 forward rows={rows}"] = lambda a=a: lbs.smpl_verts(*a)
    calls["K1 G=32 N=100"] = lambda: lbs.smpl_moments(*inputs["k1"])
    for rows, grad in inputs["k2_grad"].items():
        a = inputs["k2"][rows]
        calls[f"K2 backward kernel rows={rows}"] = (
            lambda a=a, grad=grad: lbs.smpl_verts_backward_vertex(grad, True, True, *a))
    k5 = f"K5 AR pass rows={K5_ROWS}"
    if k5.startswith(only):
        level = importlib.import_module(f"{pkg.__name__}.flows.cuda_level")
        cfg = importlib.import_module(f"{pkg.__name__}.configs").get_humaniflow_cfg_defaults()
        model = importlib.import_module(f"{pkg.__name__}.models").HumaniflowModel(
            cfg.MODEL, generator=torch.Generator().manual_seed(0))
        parts = [getattr(model, f"level_parts_{li}") for li in range(len(model.levels))]

        @torch.inference_mode()  # K5 has no backward and refuses grad mode
        def ar_pass():
            for (z, ctx), idx in zip(inputs["k5"], parts):
                level.flow_forward_level(model.flow, z, ctx, idx)

        calls[k5] = ar_pass
    calls[f"K7 rows={K7_ROWS} V=6890"] = lambda: lbs.lbs_skin_cm(*inputs["k7"])
    return {name: (cuda_ms(fn, iters), kernel_device_ms(fn, "", iters)) for name, fn in calls.items()
            if name.startswith(only)}


def time_forward_plans(iters: int = 20) -> dict:
    """K2's forward at each of the paths' row counts (K2_ROWS) through every
    row group of models/cuda_lbs.py::FORWARD_PLANS, not only the one
    forward_plan picks: {(rows, plan): (CUDA-event ms, device ms)} per call, printed as
    one JSON line per row count."""
    import json

    from ..models import cuda_lbs

    inputs = kernel_timing_inputs()["k2"]
    out = {}
    for rows, args in inputs.items():
        for plan in range(len(cuda_lbs.FORWARD_PLANS)):
            fn = lambda a=args, p=plan: cuda_lbs._smpl_verts_launch(a, p)  # noqa: E731
            out[rows, plan] = (cuda_ms(fn, iters), kernel_device_ms(fn, "smpl_verts_kernel", iters))
        print(json.dumps({"rows": rows, "picked": cuda_lbs.forward_plan(rows, 6890),
                          "ms by plan": {f"{p} {cuda_lbs.FORWARD_PLANS[p]}": [round(x, 5) for x in out[rows, p]]
                                         for p in range(len(cuda_lbs.FORWARD_PLANS))}}))
    return out


def time_raster_plans(iters: int = 20) -> dict:
    """K4 at the training shape through tiles of several key budgets
    (render/cuda_raster.py::tile_plan(256, keys)), each checked equal to the
    default tile's output: {keys: (CUDA-event ms, device ms)} per call,
    printed as one JSON line."""
    import json

    import torch

    from ..render import cuda_raster

    (sv, faces, img), kw = kernel_timing_inputs()["k4"]
    want = cuda_raster.raster(sv, faces, img, **kw)
    out = {}
    for keys in (2048, 4096, 8192, 12288, 16384, cuda_raster.MAX_TILE_KEYS):
        tile = cuda_raster.tile_plan(img, keys)
        fn = lambda t=tile: cuda_raster._raster_launch(sv, faces, img, kw["attrs"], 0, False, False, 1, t)  # noqa: E731
        got = fn()
        if not (torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])):
            raise AssertionError(f"K4 with tile {tile} differs from the default tile")
        out[keys] = (cuda_ms(fn, iters), kernel_device_ms(fn, "", iters))  # both passes and their memsets
    print(json.dumps({"K4 at B=72 256², ms by tile keys (rows, cols, row tiles, col tiles)": {
        f"{k} {cuda_raster.tile_plan(img, k)}": [round(x, 5) for x in v] for k, v in out.items()},
        "default": cuda_raster.TILE_KEYS}))
    return out


def time_moments_rows(iters: int = 20) -> dict:
    """K1 at G = 32 with N = 96, 100 and 112 rows a group (six full 16-row
    passes over the basis; six and one pass shared by four groups' tails;
    seven full passes): {label: (CUDA-event ms, device ms of the K1
    kernels)} per call, printed as one JSON line."""
    import json

    import torch

    from ..models import cuda_lbs

    args = kernel_timing_inputs()["k1"]
    out = {}
    for n in (96, 100, 112):  # the first n rows of each group; past 100, its first rows again
        a = tuple(torch.cat([t, t], dim=1)[:, :n].contiguous() for t in args[:3]) + args[3:]
        fn = lambda a=a: cuda_lbs.smpl_moments(*a)  # noqa: E731
        out[f"N={n}"] = (cuda_ms(fn, iters), kernel_device_ms(fn, "moments", iters))
    print(json.dumps({"K1 at G=32, ms": {k: [round(x, 5) for x in v] for k, v in out.items()}}))
    return out


def compare_checkouts(parent_root: str, turns: str = "pccp", only: str = "") -> dict:
    """K6, K4, K2's forward, K1, K2's backward, K5 and K7 (those whose name
    starts with `only`) of the parent checkout at `parent_root` and of this one, timed
    in turns on one card (p = parent, c = change; default parent, change,
    change, parent) on the same inputs; prints one JSON line per turn and
    returns {label: [results per turn]}."""
    import importlib
    import json
    import subprocess

    import torch

    here = importlib.import_module(__package__.rsplit(".", 1)[0])  # this checkout's humaniflow_torch
    pkgs = {"p": load_checkout(parent_root, "parent_humaniflow_torch"), "c": here}
    inputs = kernel_timing_inputs()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    out = {"parent": [], "change": []}
    for t in turns:
        label = "parent" if t == "p" else "change"
        res = time_kernels(pkgs[t], inputs, only=only)
        torch.cuda.synchronize()
        out[label].append(res)
        print(json.dumps({"turn": label, "card": card, "ms": {k: [round(x, 5) for x in v] for k, v in res.items()}}))
    return out


def staged_batch(dataset, b: int, device) -> dict:
    """The dataset's first batch of b items as the eval step takes it, with
    every array on `device` (strings dropped)."""
    import torch

    from ..data.datasets import batch_iterator
    from ..pipelines.evaluate import _assemble_host_batch

    batch = _assemble_host_batch(next(batch_iterator(dataset, b)))["batch"]
    return {k: torch.as_tensor(np.asarray(v), device=device) for k, v in batch.items() if not isinstance(v, list)}


def _print_profiles(programs: dict, iters: int = 10, top: int = 8):
    walls = {name: wall_ms(fn, iters) for name, fn in programs.items()}
    for name, fn in programs.items():
        prof = device_profile(fn, iters=min(iters, 5), top=top)
        busy = prof["device_busy_ms"]
        print(f"{name}: wall {walls[name]:.2f} ms, device busy {busy:.2f} ms, "
              f"idle share {1.0 - busy / walls[name]:.3f}, {prof['launches']:.0f} kernel launches per batch")
        for kname, ms in prof["top_kernels_ms"]:
            print(f"    {ms:8.3f} ms  {kname}")


def protocol_breakdown(protocol: str, b: int):
    """Print where one batch of an evaluation protocol spends its time."""
    import torch

    from ..configs import get_humaniflow_cfg_defaults
    from ..metrics import EvalMetricsTracker
    from ..models import HumaniflowModel, synthetic_smpl
    from ..pipelines import EVAL_METRICS_3DPW, EVAL_METRICS_SSP3D
    from ..pipelines.evaluate import _flip_x, _render_sample_silhouettes, make_eval_step
    from ..render import TexturedIUVRenderer, cuda_coverage

    ssp3d = protocol == "ssp3d"
    n, metrics = (100, EVAL_METRICS_SSP3D) if ssp3d else (10, EVAL_METRICS_3DPW)
    cfg = get_humaniflow_cfg_defaults()
    model = HumaniflowModel(cfg.MODEL, generator=torch.Generator().manual_seed(0))
    smpls = [synthetic_smpl(num_verts=6890, seed=s) for s in (0, 1, 2)]
    batch = staged_batch(SyntheticEvalDataset(b, cfg.DATA.PROXY_REP_SIZE), b, "cuda")
    eval_step = make_eval_step(model, *smpls, cfg, n, True, True)
    gen = torch.Generator("cuda")
    pred, target, proxy, extra = eval_step(batch, generator=gen.manual_seed(1))
    target.update(joints2D=batch["joints2D"], joints2D_vis=batch["joints2D_visib"], silhouettes=batch["silhouette"])
    programs = {"eval_step": lambda: eval_step(batch, generator=gen.manual_seed(1))}
    if ssp3d:
        renderer = TexturedIUVRenderer(img_wh=cfg.DATA.PROXY_REP_SIZE, render_rgb=False)

        @torch.inference_mode()
        def silhouettes():
            sil, _ = renderer.render_silhouette_with_overflow(extra["verts_flipped_point_est"], extra["cam_wp"])
            samples, _ = _render_sample_silhouettes(renderer, pred["verts3D_samples"], extra["cam_wp"])
            return sil, samples

        pred["silhouettes"], pred["silhouettessamples"] = silhouettes()
        programs["silhouettes"] = silhouettes
        with torch.inference_mode():
            cams = extra["cam_wp"][:, None].expand(b, n, 3).reshape(b * n, 3)
            screen = renderer._sil_screen(_flip_x(pred["verts3D_samples"]).reshape(b * n, -1, 3), cams)
        faces, img = renderer.dp["faces"], renderer.img_wh
        programs["k3_on_the_samples"] = lambda: cuda_coverage.coverage(screen, faces, img, cull_sign=1)
    tracker = EvalMetricsTracker(metrics, num_samples_for_prob_metrics=n, sync_every=1 << 20)

    @torch.inference_mode()
    def update():
        tracker.update_per_batch(pred, target, b, model_input=proxy)

    programs["metrics"] = update
    stages = [fn for name, fn in programs.items() if name != "k3_on_the_samples"]
    programs["whole_batch"] = lambda: [fn() for fn in stages]
    print(f"{protocol} protocol, B={b} N={n} on {torch.cuda.get_device_name(0)}, "
          f"fused level {'on' if model._fused_level_enabled() else 'off'}")
    _print_profiles(programs)


def train_breakdown(b: int):
    """Print where one synthetic batch and one train step spend their time."""
    import torch

    from ..configs import get_humaniflow_cfg_defaults
    from ..data.augmentation import Draws
    from ..models import HumaniflowModel, synthetic_smpl
    from ..pipelines import make_optimizer, make_synth_data_fn, make_train_step
    from ..render import TexturedIUVRenderer

    cfg = get_humaniflow_cfg_defaults()
    img = cfg.DATA.PROXY_REP_SIZE
    model = HumaniflowModel(cfg.MODEL, generator=torch.Generator().manual_seed(0))
    smpl = synthetic_smpl(num_verts=6890)
    renderer = TexturedIUVRenderer(
        img_wh=img, projection_type="perspective", focal_length=cfg.TRAIN.SYNTH_DATA.FOCAL_LENGTH,
        rasterizer="binned", texture_sampling="face", emit_uv=False, binned_cull=True, emit_overflow=True,
    )
    gen = torch.Generator("cuda").manual_seed(1)
    inputs = (0.3 * torch.randn((b, 72), generator=gen, device="cuda"),
              torch.rand((b, 1200, 800, 3), generator=gen, device="cuda"),
              torch.rand((b, img, img, 3), generator=gen, device="cuda"))
    draws = Draws(gen)
    synth = make_synth_data_fn(cfg, smpl, renderer)
    step = make_train_step(model, smpl, cfg.LOSS, make_optimizer(model, cfg), img_wh=img)
    batch = synth(draws, *inputs)
    batch.pop("rgb_in"), batch.pop("binning_overflow")
    print(f"training, B={b} {img}² N_j2d={cfg.LOSS.NUM_J2D_SAMPLES} on {torch.cuda.get_device_name(0)}")
    _print_profiles({
        "synth_batch": lambda: synth(draws, *inputs),
        "train_step": lambda: step(batch, generator=gen),
        "synth_and_step": lambda: step(synth(draws, *inputs), generator=gen),
    }, iters=3, top=15)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--batch", type=int, default=None, help="default 72 with --train, else 32")
    parser.add_argument("--samples", type=int, default=100)
    parser.add_argument("--protocol", choices=("ssp3d", "3dpw"), default=None)
    parser.add_argument("--train", action="store_true", help="profile one synthetic batch and one train step")
    parser.add_argument("--compare", metavar="PARENT_ROOT", default=None,
                        help="time K6, K4, K2 (forward and backward kernel), K1, K5 and K7 of the checkout at "
                             "PARENT_ROOT and of this one in turns, parent, change, change, parent")
    parser.add_argument("--only", default="", help="with --compare: only the kernels whose name starts so")
    parser.add_argument("--plans", action="store_true",
                        help="time K2's forward through every row group at the paths' row counts, K4 through "
                             "several tiles and K1 at N = 96, 100 and 112")
    parser.add_argument("--fused-level", action="store_true",
                        help="run the flow through the fused level kernel (HFT_FUSED_LEVEL=1)")
    args = parser.parse_args(argv)
    if args.fused_level:
        os.environ["HFT_FUSED_LEVEL"] = "1"

    import torch

    if not torch.cuda.is_available():
        print("profiling needs a CUDA device", file=sys.stderr)
        return 1
    if args.compare is not None:
        compare_checkouts(args.compare, only=args.only)
        return 0
    if args.plans:
        time_forward_plans()
        time_raster_plans()
        time_moments_rows()
        return 0
    batch = args.batch or (72 if args.train else 32)
    if args.protocol is not None:
        protocol_breakdown(args.protocol, batch)
        return 0
    if args.train:
        train_breakdown(batch)
        return 0
    import torch.nn.functional as F

    from ..configs import get_humaniflow_cfg_defaults
    from ..models import HumaniflowModel, smpl_forward, smpl_vertex_moments, synthetic_smpl
    from ..ops.rotation import rot6d_to_rotmat

    b, n = batch, args.samples
    cfg = get_humaniflow_cfg_defaults()
    model = HumaniflowModel(cfg.MODEL, generator=torch.Generator().manual_seed(0))
    smpl = synthetic_smpl(num_verts=6890)
    proxy = torch.rand((b, 256, 256, 18), generator=torch.Generator("cuda").manual_seed(1), device="cuda")
    gen = torch.Generator("cuda")

    @torch.inference_mode()
    def forward():
        return model.apply(proxy, generator=gen.manual_seed(2), num_samples=n, use_shape_mode_for_samples=True)

    @torch.inference_mode()
    def program():
        out = forward()
        mom = smpl_vertex_moments(
            smpl, out["shape_samples"].reshape(b * n, -1), out["pose_rotmats_samples"].reshape(b * n, 23, 3, 3),
            out["glob_rotmat"][:, None].expand(b, n, 3, 3).reshape(b * n, 3, 3), num_groups=b,
        )
        var = torch.clamp(mom[:, 1] / n - (mom[:, 0] / n) ** 2, min=0.0).sum(dim=1)
        return smpl_forward(smpl, out["shape_mode"], out["pose_rotmats_point_est"], out["glob_rotmat"]), var

    with torch.inference_mode():
        feats = model.encoder(proxy)
        x = F.elu(model.fc1(feats))
        cam = model.fc_cam(x) + model.init_cam
        glob_r = rot6d_to_rotmat(model.fc_glob(x) + model.init_glob)
        shape_mode = model.fc_shape(x)[:, : cfg.MODEL.NUM_SMPL_BETAS]
        shape_all = shape_mode[:, None].expand(b, n + 1, shape_mode.shape[-1])
        noise = model._draw_level_noise((b, n), gen.manual_seed(3))

        def heads():
            y = F.elu(model.fc1(feats))
            return model.fc_cam(y), rot6d_to_rotmat(model.fc_glob(y)), model.fc_shape(y)

        def flows():
            isgc = model._isgc_feats(feats, shape_all, glob_r, cam)
            return model._autoregress(isgc, noise, zero_sample0=True)

        split = {
            "encoder_ms": cuda_ms(lambda: model.encoder(proxy), 10),
            "heads_ms": cuda_ms(heads, 10),
            "flow_pass_ms": cuda_ms(flows, 10),
            "flow_pass_wall_ms": wall_ms(flows, 10),
        }
    print(f"B={b} N={n} on {torch.cuda.get_device_name(0)}, "
          f"fused level {'on' if model._fused_level_enabled() else 'off'}")
    print("forward split:", {k: round(v, 3) for k, v in split.items()})
    _print_profiles({"model_forward": forward, "distribution_inference": program})
    return 0


if __name__ == "__main__":
    sys.exit(main())
