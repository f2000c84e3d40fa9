"""Kernel cases and fixtures shared by the card tests (test_torch_kernels.py),
the CPU tests of the kernels' plans (test_torch_kernels_cpu.py),
chip_smoke.py and kernel_times.py: seeded inputs that reach every branch of
K3 and K6's cull, the training renderer's screen coordinates of posed
bodies, SSP-3D-shaped synthetic evaluation data staged as the eval step
takes it, and the count of a call's CUDA kernels by name."""

from typing import Dict

import numpy as np


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


def training_renderer(device="cuda", img: int = None):
    """The renderer of the synthetic-data batch at the default config
    (pipelines/train.py::make_training_renderer, culled, as run_train's
    default --cull) at img² or the default 256²."""
    import dataclasses

    from humaniflow_torch.configs import get_humaniflow_cfg_defaults
    from humaniflow_torch.pipelines.train import make_training_renderer

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

    from humaniflow_torch.models import smpl_forward
    from humaniflow_torch.ops import aa_rotate_rotmats, aa_rotate_translate_points, so3_exp

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


def staged_batch(dataset, b: int, device) -> dict:
    """The dataset's first batch of b items as the eval step takes it, with
    every array on `device` (strings dropped)."""
    import torch

    from humaniflow_torch.data.datasets import batch_iterator
    from humaniflow_torch.pipelines.evaluate import _assemble_host_batch

    batch = _assemble_host_batch(next(batch_iterator(dataset, b)))["batch"]
    return {k: torch.as_tensor(np.asarray(v), device=device) for k, v in batch.items() if not isinstance(v, list)}


def kernel_counts(fn, names, sessions: int = 3) -> Dict[str, int]:
    """The CUDA kernels of one call of fn (torch.profiler) whose name
    contains each of `names`, by name: what ran on the device, also where no
    wrapper launched it, as in a CUDA graph's replay.  A session that sees
    no device activity at all is run again, as in kernel_device_ms."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(sessions):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        kernels = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        if kernels:
            break
    return {name: sum(name in k for k in kernels) for name in names}
