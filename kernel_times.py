#!/usr/bin/env python3
"""Kernel-alone timing of the PyTorch port on one NVIDIA GPU.

    python3 kernel_times.py --compare PARENT_ROOT [--only K4]
    python3 kernel_times.py --plans

With --compare it times kernels K6, K4 (the training batch), K2's forward
(at the paths' five row counts), K1, K2's backward kernel, K5 (the 8
levels of one AR pass at 3,232 rows, summed) and K7 (3,200 rows) of another
checkout (PARENT_ROOT, e.g. the parent commit unpacked with `git archive`
into a directory that .gitignore lists) and of this one, in turns on one
card, on the same inputs: CUDA-event ms per call and the kernels' device ms
per call (torch.profiler), one JSON line per turn.  With --plans it times K2's
forward at those row counts through each of its row groups, K4 through
tiles of several key budgets and K1 at N = 96, 100 and 112.

The inputs are seeded draws on the card (K4's bodies through
tests/_torch_cases.py::training_screen).  Needs a CUDA device; it exits non-zero without one.  Where a program is to
be measured whole, use the benchmark (benchmark/run.py) and its span table
(python3 -m benchmark.harness.program_spans).
"""

import argparse
import importlib
import os
import sys
import time


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


def tests_module(name: str):
    """The helper module tests/<name>.py, imported by path (it is not a
    package)."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    try:
        return importlib.import_module(name)
    finally:
        sys.path.pop(0)


K2_ROWS = (32, 72, 320, 576, 3200)  # K2's forward rows on the paths
K2_BACKWARD_ROWS = (32, 72, 576)
K5_ROWS = 32 * 101  # one AR pass of distribution inference: B = 32, N + 1 = 101
K7_ROWS = 32 * 100
TRAIN_B = 72  # the training batch: K4's meshes


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

    from humaniflow_torch.configs import get_humaniflow_cfg_defaults
    from humaniflow_torch.models import HumaniflowModel, smpl_forward, synthetic_smpl
    from humaniflow_torch.models.smpl import _kernel_inputs
    from humaniflow_torch.ops import aa_rotate_translate_points, so3_exp
    from humaniflow_torch.render import TexturedIUVRenderer
    from humaniflow_torch.render.cuda_tiled import tile_sort_order

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
    train_renderer, train_sv = tests_module("_torch_cases").training_screen(smpl, TRAIN_B, seed + 42)
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

    from humaniflow_torch.models import cuda_lbs

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

    from humaniflow_torch.render import cuda_raster

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

    from humaniflow_torch.models import cuda_lbs

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
    import json
    import subprocess

    import torch

    import humaniflow_torch as here  # this checkout's
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


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    which = parser.add_mutually_exclusive_group(required=True)
    which.add_argument("--compare", metavar="PARENT_ROOT", default=None,
                       help="time K6, K4, K2 (forward and backward kernel), K1, K5 and K7 of the checkout at "
                            "PARENT_ROOT and of this one in turns, parent, change, change, parent")
    which.add_argument("--plans", action="store_true",
                       help="time K2's forward through every row group at the paths' row counts, K4 through "
                            "several tiles and K1 at N = 96, 100 and 112")
    parser.add_argument("--only", default="", help="with --compare: only the kernels whose name starts so")
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("kernel_times needs a CUDA device", file=sys.stderr)
        return 1
    if args.compare is not None:
        compare_checkouts(args.compare, only=args.only)
    else:
        time_forward_plans()
        time_raster_plans()
        time_moments_rows()
    return 0


if __name__ == "__main__":
    sys.exit(main())
