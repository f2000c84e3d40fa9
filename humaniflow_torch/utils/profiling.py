"""Where the time of distribution inference goes on the card.

    python -m humaniflow_torch.utils.profiling [--batch 32] [--samples 100]

Builds the default model (seeded random weights) and synthetic SMPL at 6890
vertices, then prints, for the model forward and for the whole
distribution-inference program (forward → K1 moments → variance, plus the
K2 point estimate):

* wall ms per batch (host clock around work ending in a synchronise),
  taken for both programs before the first profiler session, which leaves
  the host slower for the rest of the process;
* device busy ms per batch (union of kernel intervals in a torch.profiler
  trace) and the idle share, 1 − busy / wall;
* kernel launches per batch and the kernels that take the most device time;
* the forward split into encoder, heads and the autoregressive flow pass
  (CUDA events).

Needs a CUDA device; it exits non-zero without one.
"""

import argparse
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


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--batch", type=int, default=32)
    parser.add_argument("--samples", type=int, default=100)
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("profiling needs a CUDA device", file=sys.stderr)
        return 1
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
    print(f"B={b} N={n} on {torch.cuda.get_device_name(0)}")
    print("forward split:", {k: round(v, 3) for k, v in split.items()})
    programs = {"model_forward": forward, "distribution_inference": program}
    walls = {name: wall_ms(fn, 10) for name, fn in programs.items()}
    for name, fn in programs.items():
        prof = device_profile(fn)
        busy = prof["device_busy_ms"]
        print(f"{name}: wall {walls[name]:.2f} ms, device busy {busy:.2f} ms, "
              f"idle share {1.0 - busy / walls[name]:.3f}, {prof['launches']:.0f} kernel launches per batch")
        for kname, ms in prof["top_kernels_ms"]:
            print(f"    {ms:8.3f} ms  {kname}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
