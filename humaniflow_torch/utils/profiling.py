"""Where the time of distribution inference and evaluation goes on the card.

    python -m humaniflow_torch.utils.profiling [--batch 32] [--samples 100] [--fused-level]
    python -m humaniflow_torch.utils.profiling --protocol ssp3d|3dpw [--batch 32] [--fused-level]

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

--fused-level sets HFT_FUSED_LEVEL=1 for the run, so that the flow pass
goes through the fused level kernel K5; run the script with and without it
to compare the two configurations.

Needs a CUDA device; it exits non-zero without one.
"""

import argparse
import os
import sys
import time

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


def kernel_device_ms(fn, name: str, iters: int = 20) -> float:
    """Mean device duration (torch.profiler) of the CUDA kernels whose name
    contains `name` per call of fn, after one warm-up call: the kernel's own
    time, without the host time between launches that CUDA events around a
    loop of short launches also count."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA and name in e.name]
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


def staged_batch(dataset, b: int, device) -> dict:
    """The dataset's first batch of b items as the eval step takes it, with
    every array on `device` (strings dropped)."""
    import torch

    from ..data.datasets import batch_iterator
    from ..pipelines.evaluate import _assemble_host_batch

    batch = _assemble_host_batch(next(batch_iterator(dataset, b)))["batch"]
    return {k: torch.as_tensor(np.asarray(v), device=device) for k, v in batch.items() if not isinstance(v, list)}


def _print_profiles(programs: dict):
    walls = {name: wall_ms(fn, 10) for name, fn in programs.items()}
    for name, fn in programs.items():
        prof = device_profile(fn)
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
    from ..pipelines.evaluate import _build_eval_step, _flip_x, _render_sample_silhouettes
    from ..render import TexturedIUVRenderer, cuda_coverage

    ssp3d = protocol == "ssp3d"
    n, metrics = (100, EVAL_METRICS_SSP3D) if ssp3d else (10, EVAL_METRICS_3DPW)
    cfg = get_humaniflow_cfg_defaults()
    model = HumaniflowModel(cfg.MODEL, generator=torch.Generator().manual_seed(0))
    smpls = [synthetic_smpl(num_verts=6890, seed=s) for s in (0, 1, 2)]
    batch = staged_batch(SyntheticEvalDataset(b, cfg.DATA.PROXY_REP_SIZE), b, "cuda")
    eval_step = _build_eval_step(model, *smpls, cfg, n, True, True)
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


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--batch", type=int, default=32)
    parser.add_argument("--samples", type=int, default=100)
    parser.add_argument("--protocol", choices=("ssp3d", "3dpw"), default=None)
    parser.add_argument("--fused-level", action="store_true",
                        help="run the flow through the fused level kernel (HFT_FUSED_LEVEL=1)")
    args = parser.parse_args(argv)
    if args.fused_level:
        os.environ["HFT_FUSED_LEVEL"] = "1"

    import torch

    if not torch.cuda.is_available():
        print("profiling needs a CUDA device", file=sys.stderr)
        return 1
    if args.protocol is not None:
        protocol_breakdown(args.protocol, args.batch)
        return 0
    import torch.nn.functional as F

    from ..configs import get_humaniflow_cfg_defaults
    from ..models import HumaniflowModel, smpl_forward, smpl_vertex_moments, synthetic_smpl
    from ..ops.rotation import rot6d_to_rotmat

    b, n = args.batch, args.samples
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
