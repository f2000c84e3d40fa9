#!/usr/bin/env python3
"""Smoke test of the PyTorch port (humaniflow_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0):
1. print the card's name and power limit; build the CUDA kernels with nvcc
   (into build/torch_kernels/, one nvcc per source, all at once);
2. hold kernels K2 (smpl_verts) and K1 (smpl_moments) against their plain
   PyTorch twins at the main path's shapes and at ragged ones, and time both;
3. drive the main path through predict_humaniflow at the full width of the
   default model (ResNet-18, 256² proxy, 8-level flow, synthetic SMPL with
   6890 vertices; seeded random weights), B=32 images, N=100 samples, and
   check its outputs against the CPU path on a small input;
4. run the distribution-inference program (model → K1 moments → variance,
   plus the K2 point estimate) at B=32, N=100 and check its variance
   against predict's vertex samples drawn with the same noise;
5. hold kernel K3 (coverage) against its plain twin, bit for bit, on posed
   synthetic bodies and on hand-made ragged faces, at 256² and 200², with
   and without back-face culling, and time it at the SSP-3D shape;
6. run the SSP-3D protocol through evaluate_humaniflow (N=100, silhouette
   and per-sample silhouette IOU, B=32, 256²), check the point-estimate
   silhouettes of K3 against the exact scan, check GPU evaluation with
   exact silhouettes against CPU evaluation on a small input, and time it
   (img/s, and the split into eval step, silhouettes and metrics);
7. run the 3DPW protocol (N=10, B=32) and time it;
8. hold kernel K5 (flow_level) against its plain twin on each of the 8
   depth levels, with the contexts of the model's own autoregressive pass on
   phase 3's proxies (B·(N+1) = 3,232 rows) and on ragged row counts, for
   z ~ 0.6·N(0, 1), z = 0 and z = ±10, and time it per level;
9. drive predict_humaniflow and the distribution-inference program again
   with HFT_FUSED_LEVEL=1 (the fused-flow-level configuration: K5 once per
   level) and hold them against phases 3-4's outputs for the same noise;
10. drive uncropped-image predict at full width: 32 synthetic images of two
   sizes → predict_hrnet_batch (HRNet-W48 at 384×288, seeded random weights,
   keypoint-box fallback) → the 256² crop → predict_humaniflow with the
   fused level, N=100, with float32 and with bf16 HRNet convolutions; check
   GPU HRNet heatmaps and keypoints against the CPU on 2 images, and time it
   (img/s, and the split into HRNet, crops and predict).

Phases 1-7 run with the fused level off.  Each path of phases 3, 4, 6, 7, 9
and 10 is driven with the kernel launch counters
set to 0 just before it and read just after; launches made to compare a
kernel with its twin, or to time it, are not counted.  Prints one
{"kernels": [...]} line, then the card line as nvidia-smi gives it, and last
{"ok": true, "device": {...}}.  Without CUDA, or without the humaniflow_torch
package beside it, it exits non-zero and prints no result.
"""

import json
import os
import subprocess
import sys
import time

B, N, V, IMG = 32, 100, 6890, 256
FP32_PEAK_FLOPS = 67e12  # H100 SXM, float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
VERTS_ATOL = 2e-5  # kernel vs plain twin, metres
MOMENTS_RTOL = 1e-5  # kernel vs plain twin, relative to each moment plane's max
SLICE_ATOL = 5e-4  # GPU path vs CPU path, whole predict slice
SAMPLE0_ATOL = 1e-5  # fused sample 0 vs separate point-estimate pass on the card
VAR_RTOL, VAR_ATOL = 1e-3, 1e-6  # one-pass E[x²]−E[x]² cancellation in float32
SEAM_PX = 8  # K3 (culled) vs the exact scan, per mesh: the DensePose seam hole
METRIC_RTOL = 2e-4  # GPU vs CPU evaluation, final metrics
IOU_ATOL = 2e-2  # the same for the IOU metrics: one pixel is ~1% of a 64² silhouette
PROTOCOL_BATCHES = 6  # one warm-up batch, then five timed
LEVEL_ATOL = 2e-5  # K5 vs plain twin (the JAX package's Mosaic-vs-XLA bound for the fused level)
FUSED_ROT_ATOL = 2e-4  # fused vs eager flow, rotations (the JAX fused-vs-XLA bound)
FUSED_VAR_RTOL = 1e-2  # fused vs eager variance: sample vertices move by ≤ 5e-4 m of ~0.1 m spreads
HEATMAP_RTOL = 1e-4  # GPU vs CPU HRNet heatmaps, relative to the largest |heatmap|
SPLINE_OPS = 190  # arithmetic of one spline evaluation, counted from csrc/flow_level.cu
RADIAL_OPS = 12  # the radial tanh per row
UNCROPPED_SIZES = ((480, 640), (720, 540))  # (H, W) of the synthetic uncropped images


def _bound_ms(flops, nbytes):
    t_ops, t_bytes = flops / FP32_PEAK_FLOPS, nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def _kernel_args(smpl, rows, v, seed):
    """Kernel inputs for `rows` samples of a random pose near the rest pose,
    on the model's first v vertices."""
    import torch

    from humaniflow_torch.models.smpl import _kernel_inputs
    from humaniflow_torch.ops import so3_exp

    g = torch.Generator("cuda").manual_seed(seed)
    n = 1
    for r in rows:
        n *= r
    betas = torch.randn((n, 10), generator=g, device="cuda")
    rots = so3_exp(0.4 * torch.randn((n, 24, 3), generator=g, device="cuda"))
    _, a12, pf = _kernel_inputs(smpl, betas, rots[:, 1:], rots[:, 0])
    model = (
        smpl.v_template_cm[:, :v].contiguous(), smpl.shapedirs_cm[..., :v].contiguous(),
        smpl.posedirs_cm[..., :v].contiguous(), smpl.lbs_weights[:v].contiguous(),
    )
    return (a12.reshape(*rows, 24, 12), betas.reshape(*rows, 10), pf.reshape(*rows, 207)) + model


def _work(args, out_numel, rows, v, extra_flops_per_row_vertex=0):
    nb = args[1].shape[-1]
    fma = 3 * (nb + 207) + 288 + 12
    flops = rows * v * (2 * fma + extra_flops_per_row_vertex)
    nbytes = 4 * (sum(a.numel() for a in args) + out_numel)
    return flops, nbytes


def check_kernels(smpl):
    """Phase 2: kernels against plain twins; returns per-kernel records."""
    import torch

    from humaniflow_torch.models import cuda_lbs
    from humaniflow_torch.utils.profiling import cuda_ms

    records = {}
    for rows, v in (((37,), 1000), ((B * N,), V)):
        args = _kernel_args(smpl, rows, v, seed=1)
        got = cuda_lbs.smpl_verts(*args)
        torch.cuda.synchronize()
        want = cuda_lbs.smpl_verts_plain(*args)
        err = float((got - want).abs().max())
        print(f"K2 smpl_verts rows={rows} V={v}: max_abs_err {err:.3e} m")
        if not err <= VERTS_ATOL:
            raise AssertionError(f"K2 disagrees with its plain twin: {err} > {VERTS_ATOL}")
    flops, nbytes = _work(args, got.numel(), B * N, V)
    bound, by = _bound_ms(flops, nbytes)
    records["smpl_verts"] = dict(
        name="smpl_verts", replaces="humaniflow_tpu/models/pallas_lbs.py:155", max_abs_err=err,
        ms=cuda_ms(lambda: cuda_lbs.smpl_verts(*args), 20),
        plain_ms=cuda_ms(lambda: cuda_lbs.smpl_verts_plain(*args), 5),
        bound_ms=bound, bound_by=by,
    )

    for rows, v in (((3, 7), 1000), ((B, N), V)):
        args = _kernel_args(smpl, rows, v, seed=2)
        got = cuda_lbs.smpl_moments(*args)
        torch.cuda.synchronize()
        want = cuda_lbs.smpl_verts_moments_plain(*args)
        err = float((got - want).abs().max())
        rel = float(((got - want).abs().amax(dim=(0, 2, 3)) / want.abs().amax(dim=(0, 2, 3))).max())
        print(f"K1 smpl_moments rows={rows} V={v}: max_abs_err {err:.3e}, relative {rel:.3e}")
        if not rel <= MOMENTS_RTOL:
            raise AssertionError(f"K1 disagrees with its plain twin: {rel} > {MOMENTS_RTOL}")
    flops, nbytes = _work(args, got.numel(), B * N, V, extra_flops_per_row_vertex=9)
    bound, by = _bound_ms(flops, nbytes)
    records["smpl_moments"] = dict(
        name="smpl_moments", replaces="humaniflow_tpu/models/pallas_lbs.py:267", max_abs_err=err,
        ms=cuda_ms(lambda: cuda_lbs.smpl_moments(*args), 20),
        plain_ms=cuda_ms(lambda: cuda_lbs.smpl_verts_moments_plain(*args), 5),
        bound_ms=bound, bound_by=by,
    )
    return records


def _inputs(b, seed=0):
    import numpy as np

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:IMG, 0:IMG] / IMG
    body = np.exp(-(((xx - 0.5) / 0.15) ** 2 + ((yy - 0.5) / 0.35) ** 2))
    images = np.clip(0.2 + 0.6 * body[None, ..., None] + rng.normal(scale=0.05, size=(b, IMG, IMG, 3)), 0, 1)
    joints2d = rng.uniform(0.25 * IMG, 0.75 * IMG, size=(b, 17, 2))
    conf = rng.uniform(0.5, 1.0, size=(b, 17))
    return images.astype(np.float32), joints2d.astype(np.float32), conf.astype(np.float32)


def check_against_cpu(model, smpl, cfg):
    """The GPU path against the CPU path (plain twins, the path the tests hold
    against the JAX package) on a small input with the same weights and noise."""
    import torch

    from humaniflow_torch.models import HumaniflowModel
    from humaniflow_torch.pipelines import predict_humaniflow

    cpu_model = HumaniflowModel(cfg.MODEL, device="cpu")
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    cpu_smpl = smpl.to("cpu")
    b, n = 2, 4
    g = torch.Generator().manual_seed(3)
    noise = [torch.randn((b, n, len(p), 3), generator=g) for p in model.levels]
    images, joints2d, conf = _inputs(b, seed=3)
    want = predict_humaniflow(cpu_model, cpu_smpl, cfg, images, joints2d, conf, num_samples=n,
                              device="cpu", base_noise=noise)
    got = predict_humaniflow(model, smpl, cfg, images, joints2d, conf, num_samples=n,
                             base_noise=[z.cuda() for z in noise])
    worst = max(float((got[k].cpu() - want[k]).abs().max()) for k in want if k != "proxy_rep")
    print(f"predict on GPU vs CPU (B={b}, N={n}): max abs diff {worst:.3e}")
    if not worst <= SLICE_ATOL:
        raise AssertionError(f"GPU and CPU predict disagree: {worst} > {SLICE_ATOL}")


def _zero_counts():
    from humaniflow_torch.flows import cuda_level
    from humaniflow_torch.models import cuda_lbs
    from humaniflow_torch.render import cuda_coverage

    for counts in (cuda_lbs.LAUNCHES, cuda_coverage.LAUNCHES, cuda_level.LAUNCHES):
        for k in counts:
            counts[k] = 0


def _read_counts():
    import torch

    from humaniflow_torch.flows import cuda_level
    from humaniflow_torch.models import cuda_lbs
    from humaniflow_torch.render import cuda_coverage

    torch.cuda.synchronize()
    return {**cuda_lbs.LAUNCHES, **cuda_coverage.LAUNCHES, **cuda_level.LAUNCHES}


def _posed_screen(renderer, smpl, b, seed):
    """DensePose-vertex screen coordinates of b synthetic bodies under random
    poses (axis-angle 0.25·N(0, 1)) and shapes, camera (0.9, 0, 0.2)."""
    import torch

    from humaniflow_torch.models import smpl_forward
    from humaniflow_torch.ops import so3_exp

    g = torch.Generator("cuda").manual_seed(seed)
    pose = so3_exp(0.25 * torch.randn((b, 23, 3), generator=g, device="cuda"))
    shape = torch.randn((b, 10), generator=g, device="cuda")
    with torch.inference_mode():
        verts = smpl_forward(smpl, shape, pose, torch.eye(3, device="cuda").expand(b, 3, 3))["vertices"]
        cam = torch.tensor([0.9, 0.0, 0.2], device="cuda").expand(b, 3)
        return renderer._sil_screen(verts, cam)


def _ragged_screen(img):
    """Hand-made faces on two meshes: ordinary, zero-area, off screen,
    crossing both borders, stretched across the image, with a NaN vertex;
    each also with the opposite winding."""
    import math

    import torch

    v = torch.tensor(
        [[3.2, 4.1, 0], [17.9, 6.3, 0], [8.0, 21.7, 0],
         [30.5, 30.5, 0], [40.5, 40.5, 0], [50.5, 50.5, 0],
         [-90.0, -80.0, 0], [-60.0, -85.0, 0], [-70.0, -50.0, 0],
         [-20.0, 100.0, 0], [img + 30.0, 110.0, 0], [img / 2, 150.0, 0],
         [1.5, img - 2.5, 0], [img - 1.5, img - 2.0, 0], [img / 2, img - 1.0, 0],
         [math.nan, 10.0, 0], [20.0, 10.0, 0], [15.0, 30.0, 0]],
        device="cuda",
    )
    faces = torch.arange(18, dtype=torch.int32, device="cuda").reshape(6, 3)
    return torch.stack([v, v + 0.37]).contiguous(), torch.cat([faces, faces.flip(1)]).contiguous()


def _coverage_work(sv, faces, img, cull_sign):
    """(edge tests, kept faces) that K3's contract needs for these inputs:
    the pixels of the widened, clipped bounding box of every kept face."""
    import torch

    tests = kept = 0
    fl = faces.long()
    for m0 in range(0, sv.shape[0], 128):
        tri = sv[m0 : m0 + 128][:, fl]  # (m, F, 3, 3)
        x, y = tri[..., 0], tri[..., 1]
        area = (x[..., 1] - x[..., 0]) * (y[..., 2] - y[..., 0]) - (x[..., 2] - x[..., 0]) * (y[..., 1] - y[..., 0])
        keep = torch.isfinite(tri[..., :2]).all(-1).all(-1) & (area.abs() > 1e-9)
        if cull_sign:
            keep &= area * cull_sign > 0
        span = lambda c: (torch.clamp(torch.ceil(c.amax(-1)) + 1, max=img - 1)  # noqa: E731
                          - torch.clamp(torch.floor(c.amin(-1)) - 1, min=0) + 1).clamp(min=0).double()
        tests += float(torch.where(keep, span(x) * span(y), 0.0).sum())
        kept += int(keep.sum())
    return tests, kept


def check_coverage(smpl):
    """Phase 5: K3 against its plain twin, bit for bit; returns its record."""
    import torch

    from humaniflow_torch.render import TexturedIUVRenderer, cuda_coverage
    from humaniflow_torch.utils.profiling import cuda_ms

    for img in (IMG, 200):
        renderer = TexturedIUVRenderer(img_wh=img, render_rgb=False)
        cases = (("posed x16", _posed_screen(renderer, smpl, 16, 3), renderer.dp["faces"]),
                 ("ragged", *_ragged_screen(img)))
        for cull in (0, 1):
            for name, sv, faces in cases:
                mask, overflow = cuda_coverage.coverage(sv, faces, img, cull_sign=cull)
                torch.cuda.synchronize()
                want, want_overflow = cuda_coverage.coverage_plain(sv, faces, img, cull_sign=cull)
                diff = int((mask != want).sum())
                print(f"K3 coverage {name} {img}² cull_sign={cull}: {diff} differing px of "
                      f"{int(want.sum())} covered, overflow {int(overflow.sum())}")
                if diff or int(overflow.abs().sum()) or int(want_overflow.abs().sum()):
                    raise AssertionError(f"K3 disagrees with its plain twin ({name}, {img}², cull {cull})")

    # time at the SSP-3D shape: B·(N+1) meshes at 256², culled
    renderer = TexturedIUVRenderer(img_wh=IMG, render_rgb=False)
    m = B * (N + 1)
    sv, faces = _posed_screen(renderer, smpl, m, 4), renderer.dp["faces"]
    mask, overflow = cuda_coverage.coverage(sv, faces, IMG, cull_sign=1)
    want, _ = cuda_coverage.coverage_plain(sv[:32], faces, IMG, cull_sign=1)
    diff = int((mask[:32] != want).sum())
    print(f"K3 coverage at M={m}, {IMG}²: {diff} differing px on the first 32 meshes, overflow {int(overflow.sum())}")
    if diff or int(overflow.abs().sum()):
        raise AssertionError("K3 disagrees with its plain twin at the SSP-3D shape")
    tests, kept = _coverage_work(sv, faces, IMG, 1)
    # per test: a0·x, + b0·y, + c0 and the same for w1, then w2 = 1 − w0 − w1
    # (8 operations); per kept face ~25 for the area and the six coefficients
    flops = 8 * tests + 25 * kept
    nbytes = 4 * sv.numel() + 4 * faces.numel() + m * IMG * IMG + 4 * m
    bound, by = _bound_ms(flops, nbytes)
    print(f"K3 work at M={m}: {tests:.4e} edge tests over {kept} kept faces, {nbytes / 1e9:.3f} GB")
    return dict(
        name="coverage", replaces="humaniflow_tpu/render/binned_rasterizer.py:688", max_abs_err=float(diff),
        ms=cuda_ms(lambda: cuda_coverage.coverage(sv, faces, IMG, cull_sign=1), 20),
        plain_ms=cuda_ms(lambda: cuda_coverage.coverage_plain(sv[:32], faces, IMG, cull_sign=1), 5),
        bound_ms=bound, bound_by=by, ms_meshes=m, plain_ms_meshes=32,
    )


def _counting_renderer(**kw):
    """A TexturedIUVRenderer that also sums the overflow counts it returns
    (a device tensor, read after the run)."""
    from humaniflow_torch.render import TexturedIUVRenderer

    class CountingRenderer(TexturedIUVRenderer):
        overflow_total = 0

        def render_silhouette_with_overflow(self, vertices, cam_wp):
            mask, overflow = super().render_silhouette_with_overflow(vertices, cam_wp)
            self.overflow_total = self.overflow_total + overflow.sum()
            return mask, overflow

    return CountingRenderer(**kw)


def run_protocol(model, smpls, cfg, metrics, n_samples, renderer=None):
    """Drive evaluate_humaniflow over PROTOCOL_BATCHES batches of B images
    with the whole dataset staged on the card; returns (final metrics,
    launches, img/s over the batches after the first)."""
    import math

    import torch

    from humaniflow_torch.pipelines import evaluate_humaniflow
    from humaniflow_torch.utils.profiling import SyntheticEvalDataset

    ds = SyntheticEvalDataset(PROTOCOL_BATCHES * B, IMG)
    times = []
    _zero_counts()
    final = evaluate_humaniflow(
        model, *smpls, cfg, ds, metrics, batch_size=B, num_pred_samples=n_samples, renderer=renderer,
        generator=torch.Generator("cuda").manual_seed(11), batch_times=times, pre_stage=True,
    )
    launches = _read_counts()
    for m, v in final.items():
        if not math.isfinite(v):
            raise AssertionError(f"{m} is not finite: {v}")
    return final, launches, B * (len(times) - 1) / sum(times[1:])


def ssp3d_split(model, smpls, cfg, renderer):
    """Point-estimate silhouettes of K3 against the exact scan, and the
    per-batch split of the SSP-3D protocol (CUDA events, 5 batches after a
    warm-up, on one staged batch)."""
    import torch

    from humaniflow_torch.metrics import EvalMetricsTracker
    from humaniflow_torch.pipelines import EVAL_METRICS_SSP3D
    from humaniflow_torch.pipelines.evaluate import _build_eval_step, _render_sample_silhouettes
    from humaniflow_torch.utils.profiling import SyntheticEvalDataset, cuda_ms, staged_batch

    batch = staged_batch(SyntheticEvalDataset(B, IMG), B, "cuda")
    eval_step = _build_eval_step(model, *smpls, cfg, N, True, True)
    gen = torch.Generator("cuda")
    pred, target, proxy, extra = eval_step(batch, generator=gen.manual_seed(13))
    with torch.inference_mode():
        sil_k3, overflow = renderer.render_silhouette_with_overflow(extra["verts_flipped_point_est"], extra["cam_wp"])
        sil_exact = renderer.render_silhouette(extra["verts_flipped_point_est"], extra["cam_wp"])
    per_mesh = (sil_k3 != sil_exact).reshape(B, -1).sum(1)
    print(f"point-estimate silhouettes, K3 (culled) vs exact scan: differing px per mesh max {int(per_mesh.max())}, "
          f"total {int(per_mesh.sum())} of {int(sil_exact.sum())} covered; overflow {int(overflow.sum())}")
    if int(per_mesh.max()) > SEAM_PX or int(overflow.abs().sum()):
        raise AssertionError("K3 point-estimate silhouettes stray from the exact scan")

    def silhouettes():
        with torch.inference_mode():
            sil, _ = renderer.render_silhouette_with_overflow(extra["verts_flipped_point_est"], extra["cam_wp"])
            samples, _ = _render_sample_silhouettes(renderer, pred["verts3D_samples"], extra["cam_wp"])
        return sil, samples

    pred["silhouettes"], pred["silhouettessamples"] = silhouettes()
    target.update(joints2D=batch["joints2D"], joints2D_vis=batch["joints2D_visib"], silhouettes=batch["silhouette"])
    tracker = EvalMetricsTracker(EVAL_METRICS_SSP3D, num_samples_for_prob_metrics=N, sync_every=1 << 20)

    def metrics():
        with torch.inference_mode():
            tracker.update_per_batch(pred, target, B, model_input=proxy)

    return {
        "eval_step_ms": cuda_ms(lambda: eval_step(batch, generator=gen.manual_seed(13)), 5),
        "silhouettes_ms": cuda_ms(silhouettes, 5),
        "metrics_ms": cuda_ms(metrics, 5),
    }


def check_eval_against_cpu(model, smpls, cfg):
    """GPU evaluation with exact silhouettes against CPU evaluation: same
    weights, same noise, B=2, N=3, 64², two batches."""
    import dataclasses

    import torch

    from humaniflow_torch.models import HumaniflowModel
    from humaniflow_torch.pipelines import EVAL_METRICS_SSP3D, evaluate_humaniflow
    from humaniflow_torch.pipelines.evaluate import _build_eval_step, _render_sample_silhouettes
    from humaniflow_torch.render import TexturedIUVRenderer
    from humaniflow_torch.utils.profiling import SyntheticEvalDataset, staged_batch

    b, n, img = 2, 3, 64
    cfg64 = dataclasses.replace(cfg, DATA=dataclasses.replace(cfg.DATA, PROXY_REP_SIZE=img))
    cpu_model = HumaniflowModel(cfg.MODEL, device="cpu")
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    cpu_smpls = [s.to("cpu") for s in smpls]
    g = torch.Generator().manual_seed(12)
    noise = [(torch.randn((b, n, 10), generator=g), [torch.randn((b, n, len(p), 3), generator=g) for p in model.levels])
             for _ in range(2)]
    ds = SyntheticEvalDataset(2 * b, img=img)
    finals, sils = {}, {}
    for dev, mdl, sm in (("cuda", model, smpls), ("cpu", cpu_model, cpu_smpls)):
        renderer = TexturedIUVRenderer(img_wh=img, render_rgb=False, silhouette_exact=True, device=dev)
        finals[dev] = evaluate_humaniflow(mdl, *sm, cfg64, ds, EVAL_METRICS_SSP3D, batch_size=b, num_pred_samples=n,
                                          renderer=renderer, noise_fn=lambda i, bb, nn: noise[i], device=dev)
        batch = staged_batch(ds, b, dev)
        step = _build_eval_step(mdl, *sm, cfg64, n, True, True)
        pred, _, _, extra = step(batch, noise=tuple([noise[0][0].to(dev), [z.to(dev) for z in noise[0][1]]]))
        with torch.inference_mode():
            pe = renderer.render_silhouette(extra["verts_flipped_point_est"], extra["cam_wp"]).bool()
            samples, _ = _render_sample_silhouettes(renderer, pred["verts3D_samples"], extra["cam_wp"])
        sils[dev] = (pe.cpu(), samples.cpu())
    diff_pe = int((sils["cuda"][0] != sils["cpu"][0]).sum())
    diff_s = int((sils["cuda"][1] != sils["cpu"][1]).sum())
    print(f"evaluate on GPU (exact silhouettes) vs CPU, B={b} N={n} {img}²: silhouettes of the first batch differ in "
          f"{diff_pe} px (point estimates) and {diff_s} px (samples) of {int(sils['cpu'][1].sum())} covered")
    for m in EVAL_METRICS_SSP3D:
        got, want = finals["cuda"][m], finals["cpu"][m]
        ok = abs(got - want) <= (IOU_ATOL if "IOU" in m else METRIC_RTOL * abs(want))
        print(f"  {m}: GPU {got:.6g} CPU {want:.6g}")
        if not ok:
            raise AssertionError(f"GPU and CPU evaluation disagree on {m}: {got} vs {want}")


def _level_inputs(model, proxy, seed):
    """(parts, z, ctx) of each depth level of one eager (B, N+1) pass of the
    model on `proxy`, captured by a forward hook on the flow."""
    import torch

    captured = []
    handle = model.flow.register_forward_hook(lambda m, args, out: captured.append(args))
    try:
        with torch.inference_mode():
            model.apply(proxy, generator=torch.Generator("cuda").manual_seed(seed), num_samples=N,
                        use_shape_mode_for_samples=True)
    finally:
        handle.remove()
    if len(captured) != len(model.levels):
        raise AssertionError(f"captured {len(captured)} flow calls, expected {len(model.levels)}")
    return [(parts, z.reshape(-1, *z.shape[-2:]), ctx.reshape(-1, *ctx.shape[-2:]).contiguous())
            for z, ctx, parts in captured]


def _level_work(flow, rows, p, c_dim):
    """(operations, bytes) that one K5 launch needs for `rows` rows of p
    parts: per (row, part) and coupling, 2·in·out per dense layer, 2·out for
    bias and ReLU, two splines; then the radial tanh.  Bytes: z, ctx and x
    once, the p parts' weights once, the part indices."""
    from humaniflow_torch.flows.cuda_level import _plan

    blocks, _ = _plan(flow)
    ops = weights = 0
    for _, coupling in blocks:
        for w in coupling.hypernet.weights:
            out, inp = w.shape[1:]
            ops += 2 * inp * out + 2 * out
            weights += out * inp + out
        ops += 2 * SPLINE_OPS
    ops += RADIAL_OPS
    return rows * p * ops, 4 * (rows * p * (3 + c_dim + 3) + p * weights) + 8 * p


def check_flow_level(model, proxy):
    """Phase 8: K5 against its plain twin on every depth level at the main
    path's shape and at ragged row counts, and the twin's and the wrapper
    call's times; returns K5's record and the inputs to time it on."""
    import torch

    from humaniflow_torch.flows import cuda_level
    from humaniflow_torch.utils.profiling import cuda_ms

    flow = model.flow
    levels = _level_inputs(model, proxy, seed=21)
    g = torch.Generator("cuda").manual_seed(22)
    worst = 0.0
    call_ms, plain_ms, bounds, timing, flops_total, bytes_total = [], [], [], [], 0, 0
    with torch.inference_mode():
        for li, (parts, z_model, ctx) in enumerate(levels):
            rows, p, c_dim = ctx.shape
            normal = 0.6 * torch.randn((rows, p, 3), generator=g, device="cuda")
            tails = torch.full((rows, p, 3), 10.0, device="cuda")
            tails[rows // 2:] = -10.0
            cases = {"model noise": (z_model, ctx), "0.6·N(0,1)": (normal, ctx),
                     "z=0": (torch.zeros_like(normal), ctx), "z=±10": (tails, ctx)}
            for r in (1, 33, rows + 7):
                idx = torch.arange(r, device="cuda") % rows
                cases[f"rows={r}"] = (normal[idx].contiguous(), ctx[idx].contiguous())
            errs = []
            for name, (z, c) in cases.items():
                got = cuda_level.flow_forward_level(flow, z, c, parts)
                torch.cuda.synchronize()
                err = float((got - cuda_level.flow_forward_level_plain(flow, z, c, parts)).abs().max())
                errs.append(err)
                if not err <= LEVEL_ATOL:
                    raise AssertionError(f"K5 disagrees with its twin on level {li}, {name}: {err} > {LEVEL_ATOL}")
            worst = max(worst, *errs)
            timing.append((normal, ctx, parts))
            call_ms.append(cuda_ms(lambda: cuda_level.flow_forward_level(flow, normal, ctx, parts), 20))
            plain_ms.append(cuda_ms(lambda: cuda_level.flow_forward_level_plain(flow, normal, ctx, parts), 5))
            flops, nbytes = _level_work(flow, rows, p, c_dim)
            bounds.append(_bound_ms(flops, nbytes)[0])
            flops_total += flops
            bytes_total += nbytes
            print(f"K5 flow_level level {li} (P={p}, rows={rows}, ragged 1/33/{rows + 7}): max_abs_err "
                  f"{max(errs):.3e}; call {call_ms[-1]:.4f} ms, twin {plain_ms[-1]:.4f} ms, bound {bounds[-1]:.5f} ms")
    bound, by = _bound_ms(flops_total, bytes_total)
    print(f"K5 over one AR pass ({len(levels)} launches): calls {sum(call_ms):.4f} ms, twin {sum(plain_ms):.4f} ms, "
          f"{flops_total / 1e9:.3f} GFLOP and {bytes_total / 1e6:.2f} MB → bound {bound:.5f} ms ({by})")
    record = dict(
        name="flow_level", replaces="humaniflow_tpu/flows/pallas_level.py:237", max_abs_err=worst,
        plain_ms=sum(plain_ms), bound_ms=bound, bound_by=by, call_ms=sum(call_ms), ms_rows=len(levels[0][1]),
        plain_ms_per_level=plain_ms, bound_ms_per_level=bounds, call_ms_per_level=call_ms,
    )
    return record, timing


def time_flow_level(flow, record, timing):
    """K5's device time per level (torch.profiler) on phase 8's inputs; the
    CUDA events of phase 8 also count the wrapper's host time between these
    short launches.  Fills record["ms"] (summed over the levels)."""
    from humaniflow_torch.flows import cuda_level
    from humaniflow_torch.utils.profiling import kernel_device_ms

    per_level = [kernel_device_ms(lambda: cuda_level.flow_forward_level(flow, z, c, parts), "flow_level_kernel")
                 for z, c, parts in timing]
    record.update(ms=sum(per_level), ms_per_level=per_level)
    print(f"K5 device time per level (torch.profiler, 20 launches each): "
          f"{', '.join(f'{m:.4f}' for m in per_level)} ms; one AR pass {sum(per_level):.4f} ms "
          f"against a bound of {record['bound_ms']:.5f} ms")


def _set_fused(on: bool):
    os.environ["HFT_FUSED_LEVEL"] = "1" if on else "0"


def _uncropped_images(n, seed):
    """n synthetic uncropped RGB images alternating between the two sizes of
    UNCROPPED_SIZES: a bright upright blob off the centre on a noisy background."""
    import numpy as np

    rng = np.random.default_rng(seed)
    images = []
    for i in range(n):
        h, w = UNCROPPED_SIZES[i % 2]
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        cy, cx = rng.uniform(0.35, 0.65) * h, rng.uniform(0.3, 0.7) * w
        body = np.exp(-(((xx - cx) / (0.08 * w)) ** 2 + ((yy - cy) / (0.3 * h)) ** 2))
        img = 0.15 + 0.6 * body[..., None] + rng.normal(scale=0.05, size=(h, w, 3)).astype(np.float32)
        images.append(np.clip(img, 0.0, 1.0).astype(np.float32))
    return images


def _damped_hrnet(dtype=None, device=None, final_bias=1.0):
    """HRNet-W48 with seeded random weights: conv kernels damped ×0.25 so
    that the residual stages keep trained-magnitude activations, and a
    final-layer bias (default 1) that lifts the heatmap maxima over the 0.5
    confidence threshold, so that the keypoint-box fallback re-crops as it
    does for a trained net on a person."""
    import torch

    from humaniflow_torch.models import PoseHighResolutionNet

    hrnet = PoseHighResolutionNet(dtype=dtype, device=device, generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        for m in hrnet.modules():
            if isinstance(m, torch.nn.Conv2d):
                m.weight.mul_(0.25)
        hrnet.final_layer.bias.fill_(final_bias)
    return hrnet


def _conv_flops(net, x):
    """Operations of net's convolutions on input x: 2·(in/groups)·kh·kw per
    output element, summed over one forward (forward hooks)."""
    import torch

    total = [0]

    def count(m, args, out):
        total[0] += 2 * out.numel() * (m.in_channels // m.groups) * m.kernel_size[0] * m.kernel_size[1]

    handles = [m.register_forward_hook(count) for m in net.modules() if isinstance(m, torch.nn.Conv2d)]
    try:
        with torch.inference_mode():
            net(x)
    finally:
        for h in handles:
            h.remove()
    return total[0]


def uncropped_predict(model, smpl, cfg, hrnet, images, seed):
    """predict_hrnet_batch (keypoint-box fallback) → the square 256² crop of
    each HRNet crop → predict_humaniflow; returns (outputs, host-clock ms of
    the three stages, HRNet passes)."""
    import torch

    from humaniflow_torch.data.image_ops import batch_crop_affine
    from humaniflow_torch.pipelines import predict_humaniflow
    from humaniflow_torch.pipelines import predict_hrnet as ph

    passes = []
    handle = hrnet.register_forward_hook(lambda m, a, o: passes.append(1))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hr = ph.predict_hrnet_batch(hrnet, images)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        n, (in_w, in_h) = len(images), ph.HRNET_INPUT_WH
        side = float(max(in_w, in_h))
        crop = batch_crop_affine(
            (IMG, IMG), rgb=hr["cropped_images"], joints2d=hr["joints2D"],
            bbox_centres=torch.tensor([in_h / 2.0, in_w / 2.0], device="cuda").expand(n, 2),
            bbox_heights=torch.full((n,), side, device="cuda"), bbox_widths=torch.full((n,), side, device="cuda"),
            orig_scale_factor=1.0,
        )
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        pred = predict_humaniflow(model, smpl, cfg, crop["rgb"], crop["joints2d"], hr["joints2Dconfs"],
                                  num_samples=N, generator=torch.Generator("cuda").manual_seed(seed))
        torch.cuda.synchronize()
        t3 = time.perf_counter()
    finally:
        handle.remove()
    return {**pred, **hr}, {"hrnet": 1e3 * (t1 - t0), "crops": 1e3 * (t2 - t1), "predict": 1e3 * (t3 - t2)}, len(passes)


def check_hrnet_against_cpu(crops):
    """GPU HRNet (float32) against the CPU on 2 crops: heatmaps within
    HEATMAP_RTOL of the largest |heatmap|; keypoints equal wherever the
    heatmap's top-2 gap exceeds that tolerance.  Both nets without the
    final-layer bias, which would only shift every heatmap by a constant."""
    import torch

    from humaniflow_torch.models import get_kp_locations_confs_from_heatmaps

    gpu, cpu = _damped_hrnet(final_bias=0.0), _damped_hrnet(device="cpu", final_bias=0.0)
    with torch.inference_mode():
        hm_gpu = gpu(crops).cpu()
        hm_cpu = cpu(crops.cpu())
    tol = HEATMAP_RTOL * float(hm_cpu.abs().max())
    err = float((hm_gpu - hm_cpu).abs().max())
    kp_gpu, _ = get_kp_locations_confs_from_heatmaps(hm_gpu)
    kp_cpu, _ = get_kp_locations_confs_from_heatmaps(hm_cpu)
    top2 = hm_cpu.reshape(hm_cpu.shape[0], -1, hm_cpu.shape[-1]).topk(2, dim=1).values
    decisive = (top2[:, 0] - top2[:, 1]) > tol
    differ = (kp_gpu != kp_cpu).any(-1)
    print(f"HRNet GPU vs CPU (2 crops, 384×288, float32): heatmaps max abs diff {err:.3e} (tolerance {tol:.3e}); "
          f"keypoints differ {int(differ.sum())} of {differ.numel()}, {int((differ & decisive).sum())} of them "
          f"with a top-2 gap above the tolerance ({int(decisive.sum())} decisive)")
    if not err <= tol:
        raise AssertionError(f"GPU and CPU HRNet heatmaps disagree: {err} > {tol}")
    if bool((differ & decisive).any()):
        raise AssertionError("GPU and CPU HRNet keypoints differ where the heatmap's maximum is decisive")



def main() -> int:
    """Run the phases with the fused-level switch set as each needs it, and
    restore the caller's setting afterwards."""
    saved = os.environ.get("HFT_FUSED_LEVEL")
    try:
        return _main()
    finally:
        if saved is None:
            os.environ.pop("HFT_FUSED_LEVEL", None)
        else:
            os.environ["HFT_FUSED_LEVEL"] = saved


def _main() -> int:
    import torch

    import humaniflow_torch  # noqa: F401  (fails outside the repository)

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmuls are on; the port needs them off")
    from humaniflow_torch.configs import get_humaniflow_cfg_defaults
    from humaniflow_torch.models import HumaniflowModel, smpl_forward, smpl_vertex_moments, synthetic_smpl
    from humaniflow_torch.pipelines import EVAL_METRICS_3DPW, EVAL_METRICS_SSP3D, predict_humaniflow
    from humaniflow_torch.utils.cuda_build import build_all
    from humaniflow_torch.utils.profiling import cuda_ms, device_profile, wall_ms

    _set_fused(False)  # phases 1-7: the default configuration

    # ---- phase 1: the card and the build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    logs = build_all()
    print(f"nvcc build: {time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    cfg = get_humaniflow_cfg_defaults()
    model = HumaniflowModel(cfg.MODEL, generator=torch.Generator().manual_seed(0))
    smpl = synthetic_smpl(num_verts=V)

    # ---- phase 2: kernels against their plain twins
    records = check_kernels(smpl)
    check_against_cpu(model, smpl, cfg)

    # ---- phase 3: predict_humaniflow at B=32, N=100 (the main path)
    images, joints2d, conf = _inputs(B)
    _zero_counts()
    pred = predict_humaniflow(model, smpl, cfg, images, joints2d, conf, num_samples=N,
                              generator=torch.Generator("cuda").manual_seed(7))
    path_launches = {"predict": _read_counts()}
    if path_launches["predict"]["smpl_verts"] == 0:
        raise AssertionError("predict_humaniflow did not launch K2")
    shapes = {
        "verts_point_est": (B, V, 3), "tpose_verts": (B, V, 3), "verts_samples": (B, N, V, 3),
        "joints_samples": (B, N, 90, 3), "vertex_uncertainty_l2": (B, V),
        "vertex_uncertainty_directional": (B, V, 3), "pose_rotmats_samples": (B, N, 23, 3, 3),
        "proxy_rep": (B, IMG, IMG, 18),
    }
    for k, shape in shapes.items():
        if tuple(pred[k].shape) != shape:
            raise AssertionError(f"{k} has shape {tuple(pred[k].shape)}, expected {shape}")
    for k, v in pred.items():
        if not bool(torch.isfinite(v).all()):
            raise AssertionError(f"{k} is not finite")
    with torch.inference_mode():
        mode = model.apply(pred["proxy_rep"])
    sample0 = float((mode["pose_rotmats_point_est"] - pred["pose_rotmats_point_est"]).abs().max())
    print(f"sample 0 vs separate point-estimate pass: max abs diff {sample0:.3e}")
    if not sample0 <= SAMPLE0_ATOL:
        raise AssertionError(f"sample 0 is not the point estimate: {sample0}")

    # ---- phase 4: the distribution-inference program
    proxy = pred["proxy_rep"]

    @torch.inference_mode()
    def model_forward(generator):
        return model.apply(proxy, generator=generator, num_samples=N, use_shape_mode_for_samples=True)

    @torch.inference_mode()
    def moments(out):
        mom = smpl_vertex_moments(
            smpl, out["shape_samples"].reshape(B * N, -1),
            out["pose_rotmats_samples"].reshape(B * N, 23, 3, 3),
            out["glob_rotmat"][:, None].expand(B, N, 3, 3).reshape(B * N, 3, 3), num_groups=B,
        )
        s1, s2 = mom[:, 0] / N, mom[:, 1] / N
        return torch.clamp(s2 - s1 * s1, min=0.0).sum(dim=1)  # (B, V)

    @torch.inference_mode()
    def point_estimate(out):
        return smpl_forward(smpl, out["shape_mode"], out["pose_rotmats_point_est"], out["glob_rotmat"])["vertices"]

    def distribution_inference(seed):
        out = model_forward(torch.Generator("cuda").manual_seed(seed))
        return point_estimate(out), moments(out)

    _zero_counts()
    verts_pe, vertex_var = distribution_inference(7)
    path_launches["distribution inference"] = _read_counts()
    if path_launches["distribution inference"]["smpl_moments"] == 0:
        raise AssertionError("the distribution-inference program did not launch K1")
    want_var = (pred["vertex_uncertainty_directional"] ** 2).sum(-1)
    var_err = float((vertex_var - want_var).abs().max())
    print(f"variance from K1 moments vs predict's samples: max abs diff {var_err:.3e} m^2 "
          f"(variance up to {float(want_var.max()):.3e})")
    torch.testing.assert_close(vertex_var, want_var, rtol=VAR_RTOL, atol=VAR_ATOL)
    torch.testing.assert_close(verts_pe, pred["verts_point_est"], rtol=0, atol=VERTS_ATOL)

    # ---- timing, after the counted run
    gen = torch.Generator("cuda")
    predict_ms = wall_ms(lambda: predict_humaniflow(
        model, smpl, cfg, images, joints2d, conf, num_samples=N, generator=gen.manual_seed(8)), 5)
    program_ms = cuda_ms(lambda: distribution_inference(9), 10)
    out = model_forward(gen.manual_seed(9))
    forward_ms = cuda_ms(lambda: model_forward(gen.manual_seed(9)), 10)
    moments_ms = cuda_ms(lambda: moments(out), 10)
    pe_ms = cuda_ms(lambda: point_estimate(out), 10)
    print(f"predict_humaniflow B={B} N={N}: {predict_ms:.2f} ms/batch, {B / predict_ms * 1e3:.1f} img/s")
    print(f"distribution inference B={B} N={N}: {program_ms:.2f} ms/batch, {B / program_ms * 1e3:.1f} img/s "
          f"(model forward {forward_ms:.2f} ms, moments {moments_ms:.2f} ms, point-estimate SMPL {pe_ms:.2f} ms)")

    # ---- phase 5: K3 against its plain twin
    records["coverage"] = check_coverage(smpl)

    # ---- phase 6: the SSP-3D protocol, B=32, N=100, 256²
    smpls = (smpl, synthetic_smpl(num_verts=V, seed=1), synthetic_smpl(num_verts=V, seed=2))
    renderer = _counting_renderer(img_wh=IMG, render_rgb=False)
    final, path_launches["SSP-3D"], ssp3d_img_s = run_protocol(model, smpls, cfg, EVAL_METRICS_SSP3D, N, renderer)
    overflow = int(renderer.overflow_total)
    print(f"SSP-3D launches: {path_launches['SSP-3D']}, silhouette overflow {overflow}")
    if path_launches["SSP-3D"]["coverage"] == 0 or path_launches["SSP-3D"]["smpl_verts"] == 0:
        raise AssertionError("the SSP-3D protocol did not launch K3 and K2")
    if overflow != 0:
        raise AssertionError(f"K3 reported overflow {overflow}")
    for m in ("silhouette-IOU", "silhouettesamples-IOU"):
        if not 0.0 <= final[m] <= 1.0:
            raise AssertionError(f"{m} = {final[m]} lies outside [0, 1]")
    split = ssp3d_split(model, smpls, cfg, renderer)
    check_eval_against_cpu(model, smpls, cfg)
    print(f"SSP-3D protocol B={B} N={N} {IMG}²: {ssp3d_img_s:.2f} img/s over {PROTOCOL_BATCHES - 1} batches after a "
          f"warm-up; per batch eval step {split['eval_step_ms']:.2f} ms, silhouettes {split['silhouettes_ms']:.2f} ms, "
          f"metrics {split['metrics_ms']:.2f} ms")

    # ---- phase 7: the 3DPW protocol, B=32, N=10
    _, path_launches["3DPW"], pw3d_img_s = run_protocol(model, smpls, cfg, EVAL_METRICS_3DPW, 10)
    if path_launches["3DPW"]["smpl_verts"] == 0:
        raise AssertionError("the 3DPW protocol did not launch K2")
    print(f"3DPW protocol B={B} N=10: {pw3d_img_s:.2f} img/s over {PROTOCOL_BATCHES - 1} batches after a warm-up")

    # ---- phase 8: K5 against its plain twin on every depth level
    records["flow_level"], k5_timing = check_flow_level(model, proxy)

    # ---- phase 9: the fused-flow-level configuration on the main path
    _set_fused(True)
    _zero_counts()
    pred_f = predict_humaniflow(model, smpl, cfg, images, joints2d, conf, num_samples=N,
                                generator=torch.Generator("cuda").manual_seed(7))
    path_launches["predict, fused level"] = _read_counts()
    _zero_counts()
    verts_pe_f, vertex_var_f = distribution_inference(7)
    path_launches["distribution inference, fused level"] = _read_counts()
    for path in ("predict, fused level", "distribution inference, fused level"):
        c = path_launches[path]
        if c["flow_level"] != len(model.levels) or c["smpl_verts"] == 0:
            raise AssertionError(f"{path}: K5 launched {c['flow_level']} times (one AR pass has {len(model.levels)} "
                                 f"levels), K2 {c['smpl_verts']} times")
    if path_launches["distribution inference, fused level"]["smpl_moments"] == 0:
        raise AssertionError("the fused distribution-inference program did not launch K1")
    diffs = {k: float((pred_f[k] - pred[k]).abs().max())
             for k in ("pose_rotmats_point_est", "pose_rotmats_samples", "verts_point_est", "verts_samples")}
    print("fused vs eager flow, same noise, max abs diff: " + ", ".join(f"{k} {d:.3e}" for k, d in diffs.items()))
    for k, d in diffs.items():
        tol = FUSED_ROT_ATOL if "rotmats" in k else SLICE_ATOL
        if not d <= tol:
            raise AssertionError(f"the fused level moves {k} by {d} > {tol}")
    torch.testing.assert_close(verts_pe_f, verts_pe, rtol=0, atol=SLICE_ATOL)
    torch.testing.assert_close(vertex_var_f, vertex_var, rtol=FUSED_VAR_RTOL, atol=VAR_ATOL)
    with torch.inference_mode():
        mode_f = model.apply(pred_f["proxy_rep"])
    sample0_f = float((mode_f["pose_rotmats_point_est"] - pred_f["pose_rotmats_point_est"]).abs().max())
    print(f"fused level: sample 0 vs separate point-estimate pass: max abs diff {sample0_f:.3e}")
    if not sample0_f <= SAMPLE0_ATOL:
        raise AssertionError(f"fused level: sample 0 is not the point estimate: {sample0_f}")
    turns = {"eager": [], "fused": []}
    for on in (False, True, True, False):  # in turns, on one card
        _set_fused(on)
        turns["fused" if on else "eager"].append((
            wall_ms(lambda: predict_humaniflow(model, smpl, cfg, images, joints2d, conf, num_samples=N,
                                               generator=gen.manual_seed(8)), 5),
            cuda_ms(lambda: distribution_inference(9), 10),
            wall_ms(lambda: model_forward(gen.manual_seed(9)), 10),
        ))
    for name, runs in turns.items():
        p_ms, d_ms, f_ms = (sum(r[i] for r in runs) / len(runs) for i in range(3))
        print(f"{name} flow, B={B} N={N}: predict {p_ms:.2f} ms/batch, {B / p_ms * 1e3:.1f} img/s; distribution "
              f"inference {d_ms:.2f} ms, {B / d_ms * 1e3:.1f} img/s; model forward wall {f_ms:.2f} ms "
              f"(two turns: {', '.join(f'{r[0]:.2f}/{r[1]:.2f}/{r[2]:.2f}' for r in runs)})")

    # ---- phase 10: uncropped-image predict, HRNet-W48 at 384×288, fused level
    from humaniflow_torch.pipelines import predict_hrnet as ph

    _set_fused(True)
    uimages = _uncropped_images(B, seed=31)
    for name, dtype in (("float32", None), ("bf16", torch.bfloat16)):
        hrnet = _damped_hrnet(dtype=dtype)
        _zero_counts()
        out, _, passes = uncropped_predict(model, smpl, cfg, hrnet, uimages, seed=32)
        counts = path_launches[f"uncropped predict, HRNet {name}"] = _read_counts()
        if counts["flow_level"] == 0 or counts["smpl_verts"] == 0:
            raise AssertionError(f"uncropped predict ({name}) did not launch K5 and K2: {counts}")
        for k, shape in {**shapes, "cropped_images": (B, 384, 288, 3), "joints2D": (B, 17, 2)}.items():
            if tuple(out[k].shape) != shape:
                raise AssertionError(f"uncropped predict: {k} has shape {tuple(out[k].shape)}, expected {shape}")
        for k, v in out.items():
            if not bool(torch.isfinite(torch.as_tensor(v)).all()):
                raise AssertionError(f"uncropped predict: {k} is not finite")
        refined = int((out["bbox_heights"] < [h for h, _ in UNCROPPED_SIZES] * (B // 2)).sum())
        if dtype is None:
            check_hrnet_against_cpu(out["cropped_images"][:2])
        splits = [uncropped_predict(model, smpl, cfg, hrnet, uimages, seed=33)[1] for _ in range(3)]
        split = {k: sum(sp[k] for sp in splits) / len(splits) for k in splits[0]}
        total = sum(split.values())
        forward_ms = cuda_ms(lambda: ph._hrnet_keypoints(hrnet, out["cropped_images"]), 3)
        flops = _conv_flops(hrnet, out["cropped_images"])
        print(f"uncropped predict, HRNet {name}, B={B} N={N}: {B / total * 1e3:.2f} img/s ({total:.2f} ms/batch: "
              f"HRNet stage {split['hrnet']:.2f} ms over {passes} passes (one normalise → HRNet → decode pass "
              f"{forward_ms:.2f} ms, {flops / 1e12:.3f} TFLOP of convolutions, {flops / forward_ms / 1e9:.1f} "
              f"TFLOP/s; the rest is upload and 384×288 crops), proxy crops {split['crops']:.2f} ms, "
              f"predict {split['predict']:.2f} ms); {refined} of {B} boxes refined by the keypoint fallback")
        del hrnet
    print(f"launches by path: {path_launches}")

    # ---- profiler measurements, last: a profiler session leaves the host
    # slower for the rest of the process.  K5's device time per level, then
    # the forward's device time and launches per batch in both settings.
    time_flow_level(model.flow, records["flow_level"], k5_timing)
    for on in (False, True):
        _set_fused(on)
        prof = device_profile(lambda: model_forward(gen.manual_seed(9)), iters=5)
        print(f"model forward, fused level {'on' if on else 'off'}: device busy {prof['device_busy_ms']:.2f} ms, "
              f"{prof['launches']:.0f} kernel launches per batch")

    kernels = []
    sources = {"smpl_verts": "smpl_lbs.cu", "smpl_moments": "smpl_lbs.cu", "coverage": "coverage.cu",
               "flow_level": "flow_level.cu"}
    for name, source in sources.items():
        rec = dict(records[name])
        extra = {k: rec.pop(k) for k in ("ms_meshes", "plain_ms_meshes", "ms_rows", "ms_per_level", "call_ms",
                                         "call_ms_per_level", "plain_ms_per_level", "bound_ms_per_level") if k in rec}
        kernels.append(dict(
            name=name, route="cuda", source=f"humaniflow_torch/csrc/{source}", replaces=rec["replaces"],
            launches=sum(c[name] for c in path_launches.values()), max_abs_err=rec["max_abs_err"], ms=rec["ms"],
            plain_ms=rec["plain_ms"], bound_ms=rec["bound_ms"], bound_by=rec["bound_by"], library_ms=None, **extra,
        ))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
