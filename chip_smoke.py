#!/usr/bin/env python3
"""Smoke test of the PyTorch port (humaniflow_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0):
1. print the card's name and power limit; build the CUDA kernels with nvcc
   (into build/torch_kernels/, one nvcc per source, all at once);
2. hold kernels K2 (smpl_verts) and K1 (smpl_moments) against their plain
   PyTorch twins at the main path's shapes and at ragged ones (K1 at
   (G, N) = (1, 1), (3, 7), (2, 17), (32, 10), (4, 101), (32, 50), (16, 100)
   and (32, 100), the same bits on two launches, printing its chunks), and
   time both (K1 also at a rank's (32, 50) and (16, 100));
3. drive the main path through predict_humaniflow at the full width of the
   default model (ResNet-18, 256² proxy, 8-level flow, synthetic SMPL with
   6890 vertices; seeded random weights), B=32 images, N=100 samples, and
   check its outputs against the CPU path on a small input;
4. run the distribution-inference program (model → K1 moments → variance,
   plus the K2 point estimate) at B=32, N=100 and check its variance
   against predict's vertex samples drawn with the same noise;
5. hold kernel K3 (coverage) against its plain twin, bit for bit, on posed
   synthetic bodies and on hand-made ragged faces, at 256² and 200², with
   and without back-face culling, and on the cases that reach each branch
   of the kernel (utils/profiling.py::coverage_cases: a face over the
   whole image, all faces culled, band borders at 1024², sizes 33 and 200,
   M = 1 and 257, many large boxes, a NaN vertex, out-of-range indices),
   and time it at 3,232 posed bodies;
6. run the SSP-3D protocol through evaluate_humaniflow (N=100, silhouette
   and per-sample silhouette IOU, B=32, 256²), check the point-estimate
   silhouettes of K3 against the exact scan, time K3 in the protocol's own
   launches (12 × 256, 128 and 32 meshes a batch) beside their bounds,
   check GPU evaluation with exact silhouettes against CPU evaluation on a
   small input, and time it (img/s, and the split into eval step,
   silhouettes and metrics);
7. run the 3DPW protocol (N=10, B=32) and time it;
8. hold kernel K5 (flow_level) against its plain twin on each of the 8
   depth levels, with the contexts of the model's own autoregressive pass on
   phase 3's proxies (B·(N+1) = 3,232 rows) and on ragged row counts, for
   z ~ 0.6·N(0, 1), z = 0 and z = ±10, and time it per level;
9. drive predict_humaniflow, the distribution-inference program and the
   3DPW protocol (N=10) again on the default route (HFT_FUSED_LEVEL unset:
   under inference mode, K5 once per level) and hold them against phases
   3-4's and 7's outputs for the same noise;
10. drive uncropped-image predict at full width: 32 synthetic images of two
   sizes → predict_hrnet_batch (HRNet-W48 at 384×288, seeded random weights,
   keypoint-box fallback) → the 256² crop → predict_humaniflow on the
   default route (K5), N=100, with float32 and with bf16 HRNet convolutions; check
   GPU HRNet heatmaps and keypoints against the CPU on 2 images, and time it
   (img/s, and the split into HRNet, crops and predict);
11. training: hold kernel K4 (raster) against its plain twin, bit for bit,
   on posed bodies at 256² with the training flags and with fragments,
   linear attributes and depth gradients, culled and not, and on the cases
   of its card-only tests (384², two column tiles; 1024²; 2,400
   near-degenerate faces; 2,000 large boxes; all faces culled; NaN and
   infinite coordinates; indices out of range), printing its tile plan, and
   time it at the training batch; hold K2's forward against its twin at every row
   count the paths give it (32, 72, 320, 576, 3,200, 3,232; a rank's 16, 36,
   288 and 1,600 on phase 16's paths; 184, 179, 131, 14 and 140 on phase
   17's) and at ragged ones (1, 17, 33),
   printing the tile forward_plan picks for each, and time it at the
   paths' shapes (CUDA events and the kernel's device time); hold
   K2 with its gradient (the backward kernel, then float32 products)
   against autograd of its twin at B=32, 72 and 576, and time it; check one
   train step on the card against the CPU
   on a small batch; then train at full width with the training renderer
   (K4, per-face texels, culling): the synthetic batch at B=72 (256², 8
   joint samples), 5 train steps on fresh batches and 10 on one fixed batch
   (its loss must fall), timed (synth, upload, step, img/s), and a short
   train_humaniflow run (2 train + 1 val steps) writing a checkpoint;
12. hold kernel K6 (tiled_raster) against its plain twin, bit for bit, on 32
   posed bodies at 256² with the renderer's tile-sorted faces, on
   hand-made ragged faces at 128² and 384² and on 2,400 near-degenerate
   faces (utils/profiling.py::sliver_case: slivers whose rounding claims
   pixels beyond their tips, needles, areas just above 1e-9), and time it
   at B=32;
13. hold kernel K7 (lbs_skin) against its plain twin at B=37 and B·N=3200
   (V=6890), and its gradient (LBSSkin) against autograd of the twin, and
   time both;
14. the optimise path: from phase 3's predictions, the flow-prior
   optimisation at full width (B=32, 81 iterations, LR 1e-4) against 2D
   joints of a ground truth whose init is perturbed (not halted, J2D must
   fall), a GPU-vs-CPU check of 3 iterations at B=2, then the point-estimate
   figure (4 views and the T-pose, coloured by uncertainty) and the 18
   J2D-sorted sample renders through the tiled renderer (K6), each held
   against the exact-scan renderer (masks and depth on every pixel; colours
   may differ only where faces tie), timed, and K6 timed in the figures'
   own launches (CUDA events around each call, beside each launch's
   bound);
15. the non-default flows and the two CLIs of training and evaluation:
   (a) three configurations of the JAX factory's menu (affine coupling with
   the conditional linear PLU and flow BatchNorm, the masked spline with the
   linear PLU, the masked affine with permutations), each on the default
   route (K5 refuses them: zero launches): distribution
   inference at B=32, N=100 (K1, K2) and 3 train steps at B=72, 256²
   through the training renderer (K4, K2, K2's backward; finite losses,
   none skipped, the BatchNorm running statistics moved), timed beside
   phase 11's default flow, and one train step with flow BatchNorm GPU
   against CPU; (b) the train CLI (cli/run_train.py, --cull) on files
   written at run time (SMPL .npz files from the port's converter, 144
   train and 72 val poses, textures, JPEG backgrounds), 2 epochs and a
   resume for a third (checkpoints, log.pkl, finite losses), with the host's
   sample_batch and texture upload timed; (c) the evaluate CLI
   (cli/run_evaluate.py) on fabricated 3DPW (N=10) and SSP-3D (N=100)
   directories of 32 frames with the train CLI's last checkpoint (finite
   per-frame metrics);
16. the parallel layer (humaniflow_torch/parallel/), each rank a process
   started by parallel.spawn: (a) NCCL at world size 1: predict_humaniflow
   at B=32, N=100 on a 1-D and on a 1×1 ("data", "sample") mesh held to
   phase 3, the sharded inference program on the 1×1 mesh held to phase 4,
   one SSP-3D batch and 3 train steps at B=72 (synth batch and step) held
   to the same runs in one process, and the mesh path's overhead (predict
   img/s, train step ms) against one process, in turns in the rank; (b) 2
   gloo ranks on the one card: the 1×2 sample split of distribution
   inference on the default route (K5 once a level and K1 at (32, 50) on
   each rank) held to phase 9, a train step at
   B=72 (36 a rank) and an SSP-3D batch (16 a rank) held to one process;
   K1, K2, K3 and K4 launched on every rank; (c) the predict, evaluate and
   train CLIs with --num_devices 1 (--sample_devices 1, -D 1) on phase
   15's files, the evaluation's per-frame metrics held to phase 15c's;
17. data preparation to evaluation: a 3DPW test release fabricated at the
   real one's layout and size (tests/_torch_pw3d.py: 1080×1920 JPEG frames,
   a 200-frame sequence with two people and a missing image, a 137-frame
   one, invalid frames, f = 1,960 px) through cli/pw3d_preprocess.py on the
   card (K2 once a person, at 184, 179 and 131 rows) held to the same CLI
   on the CPU on the short sequence (labels, orientations, box corners,
   crops and 2D joints) and K2 at 131 rows held to its one-row launches bit
   for bit; cli/generate_hrnet_keypoints.py on its 494 crops (HRNet-W48 at
   384×288, B=16, float32, phase 10's damped weights from a
   reference-layout .pth) held to the CPU on 2 frames; then
   cli/run_evaluate.py -D 3dpw (N=10) on the prepared directory with phase
   15's checkpoint (finite per-frame metrics); frames/s of both CLIs.

Phases 9, 10, 15a and 16b's sample split take the default route; the others
run the eager flow (HFT_FUSED_LEVEL=0), the reference.  Each path of phases 3, 4,
6, 7, 9, 10, 11, 14, 15, 16 (in each rank) and 17 is driven with the kernel
launch counters set to 0 just before it and read just after; launches made to compare a
kernel with its twin, or to time it, are not counted.  Last, torch.profiler
counts the kernel launches of one call of K2's backward and takes the
kernels' own device ms (K1 and K4 beside their bounds).  Prints one
{"kernels": [...]} line, then the card line as nvidia-smi gives it, and last
{"ok": true, "device": {...}}.  Without CUDA, or without the humaniflow_torch
package beside it, it exits non-zero and prints no result.
"""

import importlib
import json
import os
import subprocess
import sys
import tempfile
import time

B, N, V, IMG = 32, 100, 6890, 256
FP32_PEAK_FLOPS = 67e12  # H100 SXM, float32 outside the tensor cores
TF32_PEAK_FLOPS = 495e12  # H100 SXM, TF32 on the tensor cores (dense)
FP64_PEAK_FLOPS = 34e12  # H100 SXM, float64 outside the tensor cores
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
TRAIN_B, TRAIN_NJ = 72, 8  # the training batch and its joints-2D samples (default config)
# K1 at a rank's (G, N) on a 1×2 and a 2×1 split of (B, N) (phase 16)
MOMENTS_MESH_SHAPES = (((B, N // 2), V), ((B // 2, N), V))
GRAD_RTOL = 1e-3  # GPU vs CPU train step: each gradient tensor, relative to its largest |value|
LOSS_RTOL = 2e-4  # GPU vs CPU train step: loss terms
K2_GRAD_RTOL = 1e-5  # K2's backward vs autograd of the twin, relative to the largest gradient
RASTER_TEST_OPS = 13  # K4 pass 1 per pixel test: w0, w1, w2 (8), z (4), the compare
RADIAL_OPS = 12  # the radial tanh per row
TILED_TEST_OPS = 13  # K6 per pixel test: w0, w1 (10), w2 (2), the compare
LBS_FMAS = 12 * 24 + 12  # K7 per (row, vertex): the 12 transform entries, then 3·(3 + 1)
LBS_ATOL = 2e-6  # K7 vs plain twin (FMAs against the twin's einsum)
LBS_GRAD_RTOL = 1e-5  # LBSSkin's backward vs autograd of the twin, relative to the largest gradient
OPT_STATE_RTOL = 1e-4  # GPU vs CPU optimise: each state tensor, relative to its largest |value|
OPT_LOSS_RTOL = 2e-4  # GPU vs CPU optimise: loss terms
TIE_SHARE = 1e-3  # tiled vs exact-scan figures: pixels whose colours differ (ties), of the covered pixels
VIS_SAMPLES = 18  # J2D-sorted samples rendered (the reference's 3×6 grid)
UNCROPPED_SIZES = ((480, 640), (720, 540))  # (H, W) of the synthetic uncropped images
# phase 17: a fabricated 3DPW test release at the real frames' size, camera and layout (tests/_torch_pw3d.py):
# a sequence of 200 frames with two people and one missing image, one of 137 frames with one person, some
# frames of each person invalid (the longer sequence cut from 400 frames: the host takes 34-50 ms a frame)
PW3D_FRAME_WH, PW3D_FOCAL = (1080, 1920), 1960.0
PW3D_SEQUENCES = (
    {"name": "downtown_walkUphill_00", "frames": 200, "missing": (100,),
     "people": (("m", tuple(range(50, 65))), ("f", (*range(10), *range(190, 200))))},
    {"name": "office_phoneCall_00", "frames": 137, "people": (("f", tuple(range(0, 137, 25))),)},
)
PW3D_CPU_SEQUENCE = "office_phoneCall_00"  # the sequence the card's preprocessing is held to the CPU's on
PW3D_ROT_ATOL = 1e-5  # card vs CPU: the rotations each side logs
PW3D_LOG_ATOL = 2e-3  # each side's orientation against the rotation it logs (tests/test_torch_scripts_pw3d.py)
PW3D_J2D_ATOL = 1e-2  # card vs CPU 2D joints, px
PW3D_CORNER_ATOL = 5e-2  # card vs CPU box corners before rounding, px
PW3D_CLEAR_SHARE = 0.9  # frames held crop for crop: at least this share


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

    worst, mesh_records = 0.0, {}
    for rows, v in (((1, 1), 1000), ((3, 7), 1000), ((2, 17), V), ((B, 10), V), ((4, 101), V)) + MOMENTS_MESH_SHAPES \
            + (((B, N), V),):
        args = _kernel_args(smpl, rows, v, seed=2)
        got = cuda_lbs.smpl_moments(*args)
        again = cuda_lbs.smpl_moments(*args)
        torch.cuda.synchronize()
        want = cuda_lbs.smpl_verts_moments_plain(*args)
        err = float((got - want).abs().max())
        worst = max(worst, err)
        rel = float(((got - want).abs().amax(dim=(0, 2, 3)) / want.abs().amax(dim=(0, 2, 3))).max())
        blocks = cuda_lbs.moments_blocks(*rows)
        chunks = [len(c) for c in blocks[0]] + ([[len(c) for c in blocks[-1]]] if len(blocks) > rows[0] else [])
        print(f"K1 smpl_moments (G, N)={rows} V={v}: chunks of a group's block [and of a tail block] {chunks}; "
              f"max_abs_err {err:.3e}, relative {rel:.3e}, same bits on two launches {torch.equal(got, again)}")
        if not rel <= MOMENTS_RTOL:
            raise AssertionError(f"K1 disagrees with its plain twin: {rel} > {MOMENTS_RTOL}")
        if not torch.equal(got, again):
            raise AssertionError(f"K1 gave other bits on a second launch at (G, N)={rows}")
        if (rows, v) in MOMENTS_MESH_SHAPES:  # a rank's shape on phase 16's sample and data splits
            g, n = rows
            bound, by = _bound_ms(*_work(args, got.numel(), g * n, V, extra_flops_per_row_vertex=9))
            ms = cuda_ms(lambda: cuda_lbs.smpl_moments(*args), 20)
            mesh_records[f"g{g}_n{n}"] = dict(ms=ms, bound_ms=bound)
            print(f"K1 at a rank's (G, N)=({g}, {n}): {ms:.4f} ms per call (CUDA events) against a bound of "
                  f"{bound:.4f} ms ({by})")
    flops, nbytes = _work(args, got.numel(), B * N, V, extra_flops_per_row_vertex=9)
    bound, by = _bound_ms(flops, nbytes)
    ms = cuda_ms(lambda: cuda_lbs.smpl_moments(*args), 20)
    print(f"K1 at (G, N)=({B}, {N}) V={V}: {ms:.4f} ms per call (CUDA events) against a bound of {bound:.4f} ms "
          f"({by})")
    records["smpl_moments"] = dict(
        name="smpl_moments", replaces="humaniflow_tpu/models/pallas_lbs.py:267", max_abs_err=worst, ms=ms,
        plain_ms=cuda_ms(lambda: cuda_lbs.smpl_verts_moments_plain(*args), 5),
        bound_ms=bound, bound_by=by,
        **{f"{key}_{shape}": rec[key] for shape, rec in mesh_records.items() for key in ("ms", "bound_ms")},
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


def _all_counts():
    from humaniflow_torch.flows import cuda_level
    from humaniflow_torch.models import cuda_lbs
    from humaniflow_torch.render import cuda_coverage, cuda_raster, cuda_tiled

    return cuda_lbs.LAUNCHES, cuda_coverage.LAUNCHES, cuda_level.LAUNCHES, cuda_raster.LAUNCHES, cuda_tiled.LAUNCHES


def _zero_counts():
    for counts in _all_counts():
        for k in counts:
            counts[k] = 0


def _read_counts():
    import torch

    torch.cuda.synchronize()
    out = {}
    for counts in _all_counts():
        out.update(counts)
    return out


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


def _coverage_bound(sv, faces, img=IMG, cull_sign=1):
    """(bound ms, bound_by) of K3 on these inputs: per edge test a0·x, + b0·y,
    + c0 and the same for w1, then w2 = 1 − w0 − w1 (8 operations), per kept
    face ~25 for the area and the six coefficients; the screen vertices, the
    faces, the mask and the overflow counts once."""
    m = sv.shape[0]
    tests, kept = _coverage_work(sv, faces, img, cull_sign)
    nbytes = 4 * sv.numel() + 4 * faces.numel() + m * img * img + 4 * m
    return (*_bound_ms(8 * tests + 25 * kept, nbytes), tests, kept)


def check_coverage(smpl):
    """Phase 5: K3 against its plain twin, bit for bit; returns its record."""
    import torch

    from humaniflow_torch.render import TexturedIUVRenderer, cuda_coverage
    from humaniflow_torch.utils.profiling import coverage_cases, cuda_ms

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
    # the cases that reach every branch of the kernel: bands, the large-box
    # queue, ragged mask words, culled meshes, out-of-range indices
    for name, (sv, faces, img, cull) in coverage_cases("cuda").items():
        mask, overflow = cuda_coverage.coverage(sv, faces, img, cull_sign=cull)
        torch.cuda.synchronize()
        want, want_overflow = cuda_coverage.coverage_plain(sv, faces, img, cull_sign=cull)
        diff = int((mask != want).sum())
        print(f"K3 coverage, {name}: M={sv.shape[0]} F={faces.shape[0]} {img}² cull_sign={cull}: {diff} differing px "
              f"of {int(want.sum())} covered, overflow {overflow.tolist()[:3]}")
        if diff or not torch.equal(overflow, want_overflow):
            raise AssertionError(f"K3 disagrees with its plain twin ({name})")

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
    bound, by, tests, kept = _coverage_bound(sv, faces)
    print(f"K3 work at M={m}: {tests:.4e} edge tests over {kept} kept faces")
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
    from humaniflow_torch.pipelines.evaluate import _render_sample_silhouettes, make_eval_step
    from humaniflow_torch.utils.profiling import SyntheticEvalDataset, cuda_ms, staged_batch

    batch = staged_batch(SyntheticEvalDataset(B, IMG), B, "cuda")
    eval_step = make_eval_step(model, *smpls, cfg, N, True, True)
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

    # K3 in the protocol's own launches on this batch: 8 samples of every
    # image a launch (12 × 256 meshes, then 128), and the 32 point estimates
    from humaniflow_torch.pipelines.evaluate import _flip_x
    from humaniflow_torch.render import cuda_coverage

    verts = pred["verts3D_samples"]
    b, n, v = verts.shape[:3]
    groups = {}
    with torch.inference_mode():
        for s0 in range(0, n, 8):
            k = min(8, n - s0)
            cam = extra["cam_wp"][:, None].expand(b, k, 3).reshape(b * k, 3)
            sv = renderer._sil_screen(_flip_x(verts[:, s0 : s0 + k]).reshape(b * k, v, 3), cam)
            groups.setdefault(b * k, []).append(sv)
        groups.setdefault(b, []).append(renderer._sil_screen(extra["verts_flipped_point_est"], extra["cam_wp"]))
    faces = renderer.dp["faces"]
    k3 = {}
    for m, svs in sorted(groups.items(), reverse=True):
        ms = cuda_ms(lambda svs=svs: [cuda_coverage.coverage(sv, faces, IMG, cull_sign=1) for sv in svs], 5) / len(svs)
        bounds = [_coverage_bound(sv, faces) for sv in svs]
        k3[m] = dict(launches=len(svs), ms=ms, bound_ms=sum(x[0] for x in bounds) / len(svs),
                     tests=sum(x[2] for x in bounds) / len(svs))
        print(f"K3 in the SSP-3D launches, M={m}: {len(svs)} per batch, {ms:.4f} ms each against a bound of "
              f"{k3[m]['bound_ms']:.4f} ms ({bounds[0][1]}), {k3[m]['tests']:.4e} edge tests each")

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
        "k3": k3,
    }


def check_eval_against_cpu(model, smpls, cfg):
    """GPU evaluation with exact silhouettes against CPU evaluation: same
    weights, same noise, B=2, N=3, 64², two batches."""
    import dataclasses

    import torch

    from humaniflow_torch.models import HumaniflowModel
    from humaniflow_torch.pipelines import EVAL_METRICS_SSP3D, evaluate_humaniflow
    from humaniflow_torch.pipelines.evaluate import _render_sample_silhouettes, make_eval_step
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
        step = make_eval_step(mdl, *sm, cfg64, n, True, True)
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
    """(MLP products, other float32 operations, float64 spline operations,
    bytes) that one K5 launch needs for `rows` rows of p parts: per (row,
    part) and coupling, 2·in·out products per dense layer, 2·out for bias and
    ReLU, and two splines; then the radial tanh.  Bytes: z, ctx and x once,
    the p parts' weights once, the part indices."""
    from humaniflow_torch.flows.cuda_level import _plan

    blocks, _ = _plan(flow)
    products = rest = splines = weights = 0
    for _, coupling in blocks:
        for w in coupling.hypernet.weights:
            out, inp = w.shape[1:]
            products += 2 * inp * out
            rest += 2 * out
            weights += out * inp + out
        splines += 2 * SPLINE_OPS
    rest += RADIAL_OPS
    return (rows * p * products, rows * p * rest, rows * p * splines,
            4 * (rows * p * (3 + c_dim + 3) + p * weights) + 8 * p)


def _level_bound_ms(products, rest, splines, nbytes):
    """(bound ms, bound_by) of K5 as it computes: the MLP's products three
    times over (3xTF32) at the tensor cores' TF32 rate, the splines at the
    float64 rate and the other operations at the float32 rate, against the
    bytes at the memory rate."""
    t_ops = 3 * products / TF32_PEAK_FLOPS + rest / FP32_PEAK_FLOPS + splines / FP64_PEAK_FLOPS
    t_bytes = nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


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
    call_ms, plain_ms, bounds, timing, work_total = [], [], [], [], [0, 0, 0, 0]
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
            work = _level_work(flow, rows, p, c_dim)
            bounds.append(_level_bound_ms(*work)[0])
            work_total = [a + b for a, b in zip(work_total, work)]
            print(f"K5 flow_level level {li} (P={p}, rows={rows}, ragged 1/33/{rows + 7}): max_abs_err "
                  f"{max(errs):.3e}; call {call_ms[-1]:.4f} ms, twin {plain_ms[-1]:.4f} ms, bound {bounds[-1]:.5f} ms")
    bound, by = _level_bound_ms(*work_total)
    products, rest, splines, nbytes = work_total
    print(f"K5 over one AR pass ({len(levels)} launches): calls {sum(call_ms):.4f} ms, twin {sum(plain_ms):.4f} ms, "
          f"{products / 1e9:.3f} GFLOP of MLP products (3xTF32 on the tensor cores), {splines / 1e9:.3f} GFLOP "
          f"of float64 splines, {rest / 1e9:.3f} GFLOP else and {nbytes / 1e6:.2f} MB → bound {bound:.5f} ms ({by})")
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
    import torch

    from humaniflow_torch.flows import cuda_level
    from humaniflow_torch.utils.profiling import kernel_device_ms

    with torch.inference_mode():  # K5 has no backward and refuses grad mode
        per_level = [kernel_device_ms(lambda: cuda_level.flow_forward_level(flow, z, c, parts), "flow_level_kernel")
                     for z, c, parts in timing]
    record.update(ms=sum(per_level), ms_per_level=per_level)
    print(f"K5 device time per level (torch.profiler, 20 launches each): "
          f"{', '.join(f'{m:.4f}' for m in per_level)} ms; one AR pass {sum(per_level):.4f} ms "
          f"against a bound of {record['bound_ms']:.5f} ms")


def _set_fused(on: bool):
    """The route of the phases that follow: True the program's default (K5
    when grad mode is off and the flow is one K5 takes), False the eager
    flow (HFT_FUSED_LEVEL=0).  A rank spawned after it inherits it."""
    if on:
        os.environ.pop("HFT_FUSED_LEVEL", None)
    else:
        os.environ["HFT_FUSED_LEVEL"] = "0"


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
    ph = importlib.import_module("humaniflow_torch.pipelines.predict_hrnet")  # the module, not the function

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



def _training_renderer():
    """The renderer of the training configuration
    (utils/profiling.py::training_renderer), checked to route to K4."""
    from humaniflow_torch.utils.profiling import training_renderer

    renderer = training_renderer()
    if renderer.rasterizer != "binned":
        raise AssertionError("the training renderer did not route to the attribute rasterizer")
    return renderer


def _hold_raster(name, sv, faces, img, kw, allow_overflow=False):
    """K4 against its plain twin on one case, bit for bit in depth, face
    ids, barycentrics, planes and overflow; returns K4's outputs."""
    import torch

    from humaniflow_torch.render import cuda_raster

    got = cuda_raster.raster(sv, faces, img, **kw)
    torch.cuda.synchronize()
    want = cuda_raster.raster_plain(sv, faces, img, **kw)
    diff = int((got[0] != want[0]).sum())
    if got[1] is not None:
        diff += sum(int((a != b).sum()) for a, b in zip(got[1], want[1]))
    diff += int((got[2] != want[2]).sum()) + int((got[3] != want[3]).sum())
    covered = int((want[0] < 1e9).sum())
    print(f"K4 raster, {name}: tile {cuda_raster.tile_plan(img)}, {diff} differing values, {covered} covered px, "
          f"overflow {got[3].tolist()[:4]}")
    if diff or covered == 0 or (not allow_overflow and int(want[3].abs().sum())):
        raise AssertionError(f"K4 disagrees with its plain twin ({name})")
    return got


def check_raster(smpl):
    """Phase 11a: K4 against its plain twin, bit for bit, and its time at the
    training batch beside its bound, with its tile plan; returns its
    record."""
    import torch

    from humaniflow_torch.render import cuda_raster
    from humaniflow_torch.utils.profiling import coverage_cases, cuda_ms, sliver_case, training_screen

    faces = _training_renderer().dp["faces"]
    f = faces.shape[0]
    sv = training_screen(smpl, 6, seed=41)[1]
    g = torch.Generator("cuda").manual_seed(44)
    rand = lambda *shape: torch.randn(shape, generator=g, device="cuda")  # noqa: E731
    cases = {
        "training flags: 4 constants, culled": dict(attrs=rand(6, f, 4), emit_frags=False, cull_sign=1),
        "fragments, 2 linear + 1 constant, z_grads": dict(attrs=rand(1, f, 7), n_lin=2, z_grads=True, cull_sign=0),
        "the same, culled": dict(attrs=rand(1, f, 7), n_lin=2, z_grads=True, cull_sign=1),
    }
    for name, kw in cases.items():
        _hold_raster(f"6 posed bodies at {IMG}², {name}", sv, faces, IMG, kw)
    # the cases of tests/test_torch_kernels.py: several tiles in both
    # directions, near-degenerate faces, big boxes past a block's queue, all
    # faces culled, non-finite coordinates, indices out of range
    cov = coverage_cases("cuda")
    sv384 = training_screen(smpl, 3, seed=45, img=384)[1]
    bad_sv = sv[:2].clone()
    bad_sv[0, 100:400] = float("nan")
    bad_sv[1, 500:520, 2] = float("inf")
    bad_sv[1, 700:720, 0] = -float("inf")
    oob = torch.tensor([[0, 1, sv.shape[1]], [-1, 2, 3], [4, sv.shape[1] + 7, 5]], dtype=torch.int32, device="cuda")
    edge = {
        "3 posed bodies at 384² (2 column tiles)": (sv384, faces, 384, 1, 0),
        "faces across band borders at 1024², NaN vertex, 2 indices out of range":
            cov["band borders at 1024², NaN vertex, 2 indices out of range"][:3] + (0, 2),
        "2,400 near-degenerate faces at 256²": sliver_case(IMG) + (IMG, 0, 0),
        "2,000 large boxes": cov["2,000 large boxes"][:3] + (0, 0),
        "all culled, and its mirror all kept": cov["all culled, and its mirror all kept"][:3] + (1, 0),
        "NaN and infinite coordinates": (bad_sv.contiguous(), faces, IMG, 1, 0),
        "3 indices out of range": (sv[:2], torch.cat([faces, oob]).contiguous(), IMG, 0, 3),
    }
    for name, (v, fcs, img, cull, want_overflow) in edge.items():
        attrs = rand(1, fcs.shape[0], 5)
        got = _hold_raster(name, v, fcs, img, dict(attrs=attrs, n_lin=1, z_grads=True, cull_sign=cull),
                           allow_overflow=True)
        if got[3].tolist() != [want_overflow] * v.shape[0]:
            raise AssertionError(f"K4 overflow {got[3].tolist()} on {name}; expected {want_overflow} per mesh")

    # time at the training shape: B meshes, the face-texel render's 4 constants, culled
    sv = training_screen(smpl, TRAIN_B, seed=42)[1]
    attrs = rand(TRAIN_B, f, 4)
    run = lambda m: cuda_raster.raster(sv[:m], faces, IMG, attrs=attrs[:m], emit_frags=False, cull_sign=1)  # noqa: E731
    depth, _, _, overflow = run(TRAIN_B)
    want = cuda_raster.raster_plain(sv[:4], faces, IMG, attrs=attrs[:4], emit_frags=False, cull_sign=1)
    if not torch.equal(depth[:4], want[0]) or int(overflow.abs().sum()):
        raise AssertionError("K4 disagrees with its plain twin at the training shape")
    tests, kept = _coverage_work(sv, faces, IMG, 1)
    covered = int((depth < 1e9).sum())
    # pass 1: RASTER_TEST_OPS per pixel test, ~45 per kept face (area, coefficients,
    # box); pass 2: ~45 per covered pixel (coefficients again, w0, w1, the planes)
    flops = RASTER_TEST_OPS * tests + 45 * kept + 45 * covered
    nbytes = 4 * (sv.numel() + faces.numel() + attrs.numel() + depth.numel() * (1 + 4) + TRAIN_B)
    bound, by = _bound_ms(flops, nbytes)
    ms = cuda_ms(lambda: run(TRAIN_B), 20)
    plain_ms = cuda_ms(
        lambda: cuda_raster.raster_plain(sv[:4], faces, IMG, attrs=attrs[:4], emit_frags=False, cull_sign=1), 2)
    rows, cols, row_tiles, col_tiles = cuda_raster.tile_plan(IMG)
    print(f"K4 at B={TRAIN_B}, {IMG}²: tiles of {rows}×{cols} px ({rows * cols * 8 // 1024} KB of keys), "
          f"{TRAIN_B * row_tiles * col_tiles} blocks; {tests:.4e} pixel tests over {kept} kept faces, {covered} "
          f"covered px, {nbytes / 1e9:.3f} GB; {ms:.4f} ms per batch (CUDA events) against a bound of {bound:.4f} ms "
          f"({by}); twin {plain_ms:.2f} ms on 4 meshes")
    return dict(
        name="raster", replaces="humaniflow_tpu/render/binned_rasterizer.py:76", max_abs_err=0.0, ms=ms,
        plain_ms=plain_ms, bound_ms=bound, bound_by=by, ms_meshes=TRAIN_B, plain_ms_meshes=4,
        tile=[rows, cols, row_tiles, col_tiles],
    )


def _pw3d_rows():
    """K2's rows in phase 17's pw3d_preprocess: each person's valid frames
    with an image, one call a person (tests/_torch_pw3d.py::smpl_rows)."""
    return tuple(_pw3d_helpers().smpl_rows(PW3D_SEQUENCES))


def _forward_rows():
    """K2's forward rows on the paths, then a rank's on phase 16b's (point
    estimates of 16 eval images, 36 training images and their 288 joint
    samples, 1,600 eval samples), then phase 17's: one call a person in
    pw3d_preprocess, and the evaluate CLI's last batch of the prepared
    frames (and its 10 samples each)."""
    pw3d = _pw3d_rows()
    tail = sum(pw3d) % B
    return (B, TRAIN_B, 10 * B, TRAIN_B * TRAIN_NJ, B * N, B * (N + 1),
            B // 2, TRAIN_B // 2, TRAIN_B * TRAIN_NJ // 2, B * N // 2,
            *pw3d, tail, 10 * tail)


RAGGED_ROWS = (1, 17, 33)


def check_smpl_verts_plans(smpl, record):
    """Phase 11b: K2's forward against its twin at every row count the paths
    give it (32 optimise and point estimates, 72 training, 320 3DPW samples,
    576 training samples, 3,200 predict samples, 3,232 the SSP-3D eval step,
    a rank's on phase 16's paths, phase 17's people and last eval batch)
    and at ragged ones, each through the tile forward_plan picks (printed);
    its time at the paths' shapes (CUDA events) beside the bound; added to
    K2's record."""
    import torch

    from humaniflow_torch.models import cuda_lbs
    from humaniflow_torch.utils.profiling import cuda_ms

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    worst = 0.0
    forward_rows = _forward_rows()
    for rows in sorted(forward_rows + RAGGED_ROWS):
        args = _kernel_args(smpl, (rows,), V, seed=rows)
        plan = cuda_lbs.forward_plan(rows, V, sms)
        before = cuda_lbs.LAUNCHES["smpl_verts"]
        got = cuda_lbs.smpl_verts(*args)
        torch.cuda.synchronize()
        if cuda_lbs.LAUNCHES["smpl_verts"] != before + 1:
            raise AssertionError(f"K2's forward did not launch exactly once at rows={rows}")
        err = float((got - cuda_lbs.smpl_verts_plain(*args)).abs().max())
        worst = max(worst, err)
        line = f"K2 forward rows={rows}: plan {plan} {cuda_lbs.FORWARD_PLANS[plan]} (rows × vertices a block), " \
               f"max_abs_err {err:.3e} m"
        if rows in forward_rows:
            ms = cuda_ms(lambda: cuda_lbs.smpl_verts(*args), 20)
            bound = _bound_ms(*_work(args, rows * 3 * V, rows, V))[0]
            record.update({f"forward_ms_b{rows}": ms, f"forward_bound_ms_b{rows}": bound, f"plan_b{rows}": plan})
            line += f"; {ms:.4f} ms per call, bound {bound:.4f} ms"
        print(line)
        if not err <= VERTS_ATOL:
            raise AssertionError(f"K2's forward disagrees with its twin at rows={rows}: {err} > {VERTS_ATOL}")
    record["max_abs_err"] = max(record["max_abs_err"], worst)


def check_smpl_backward(smpl):
    """Phase 11b: K2 with its gradient against autograd of its twin at the
    rows the paths give it (B = 32 in the optimise loop; B = 72 targets and
    point estimates, B·N = 576 samples in training); returns the backward's
    record."""
    import torch

    from humaniflow_torch.models import cuda_lbs
    from humaniflow_torch.utils.profiling import cuda_ms

    out = {}
    for rows in (B, TRAIN_B, TRAIN_B * TRAIN_NJ):
        args = _kernel_args(smpl, (rows,), V, seed=7)
        leaf = [a.detach().requires_grad_(i < 3) for i, a in enumerate(args)]
        grad = torch.randn((rows, 3, V), generator=torch.Generator("cuda").manual_seed(8), device="cuda")
        verts = cuda_lbs.smpl_verts_differentiable(*leaf)
        before = cuda_lbs.LAUNCHES["smpl_verts_backward"]
        got = torch.autograd.grad(verts, leaf[:3], grad)
        if cuda_lbs.LAUNCHES["smpl_verts_backward"] != before + 1:
            raise AssertionError("K2's backward did not launch its kernel exactly once")
        plain = cuda_lbs.smpl_verts_plain(*leaf)
        want = torch.autograd.grad(plain, leaf[:3], grad)
        fwd_err = float((verts - plain).detach().abs().max())
        rel = max(float((a - w).abs().max() / w.abs().max()) for a, w in zip(got, want))
        err = max(float((a - w).abs().max()) for a, w in zip(got, want))
        needs = [True] * 3 + [False] * 4
        bwd_ms = cuda_ms(lambda: cuda_lbs.smpl_verts_backward(grad, needs, *args), 10)
        plain_ms = cuda_ms(lambda: torch.autograd.grad(cuda_lbs.smpl_verts_plain(*leaf), leaf[:3], grad), 5)
        nb = args[1].shape[-1]
        # t12 (24·12), dp (9), the posed vertices (3·(nb + 207)), G12 (9), dA (12·24),
        # dβ (3·nb), dpose_feature (3·207) multiply-adds per (row, vertex)
        flops = 2 * rows * V * (288 + 9 + 3 * (nb + 207) + 9 + 288 + 3 * nb + 3 * 207)
        nbytes = 4 * (grad.numel() + sum(a.numel() for a in args) + sum(a.numel() for a in args[:3]))
        bound, by = _bound_ms(flops, nbytes)
        print(f"K2 with its gradient, rows={rows}: forward max_abs_err {fwd_err:.3e} m; backward max_abs_err "
              f"{err:.3e}, {rel:.3e} of the largest; backward {bwd_ms:.4f} ms (bound {bound:.4f} ms, {by}), "
              f"autograd of the twin (forward + backward) {plain_ms:.4f} ms")
        if not (fwd_err <= VERTS_ATOL and rel <= K2_GRAD_RTOL):
            raise AssertionError(f"K2's gradient disagrees with autograd of its twin at rows={rows}: {rel}")
        out[rows] = dict(err=err, bwd_ms=bwd_ms, plain_ms=plain_ms, bound=bound, by=by)
    b = out[TRAIN_B * TRAIN_NJ]
    return dict(
        name="smpl_verts_backward", replaces="humaniflow_tpu/models/pallas_lbs.py:364",
        max_abs_err=max(o["err"] for o in out.values()), ms=b["bwd_ms"], plain_ms=b["plain_ms"],
        bound_ms=b["bound"], bound_by=b["by"], ms_rows=TRAIN_B * TRAIN_NJ,
        **{f"{k}_b{rows}": o[v] for rows, o in out.items()
           for k, v in (("ms", "bwd_ms"), ("bound_ms", "bound"))},
    )


def profile_smpl_backward(smpl, record):
    """Kernel launches and device busy ms of one call of K2's backward (the
    kernel and the products) at the optimise loop's 32 rows and training's
    576, by torch.profiler; added to the backward's record."""
    import torch

    from humaniflow_torch.models import cuda_lbs
    from humaniflow_torch.utils.profiling import device_profile

    for rows in (B, TRAIN_B * TRAIN_NJ):
        args = _kernel_args(smpl, (rows,), V, seed=7)
        grad = torch.randn((rows, 3, V), generator=torch.Generator("cuda").manual_seed(8), device="cuda")
        needs = [True] * 3 + [False] * 4
        prof = device_profile(lambda: cuda_lbs.smpl_verts_backward(grad, needs, *args), iters=5)
        record[f"launches_per_call_b{rows}"] = prof["launches"]
        record[f"device_busy_ms_b{rows}"] = prof["device_busy_ms"]
        print(f"K2's backward, rows={rows}: {prof['launches']:.0f} kernel launches per call, device busy "
              f"{prof['device_busy_ms']:.4f} ms; {prof['top_kernels_ms'][:4]}")


def profile_kernel_device_times(smpl, records):
    """The kernels' own device time per call (torch.profiler), without the
    wrapper's host time that CUDA events around back-to-back calls also
    count where the launches are short: K2's forward at the paths' rows,
    K2's backward kernel at 32, 72 and 576 rows, K1 at (32, 100), K4 at the
    training batch and K6 at phase 12's shape; added to the records."""
    import torch

    from humaniflow_torch.models import cuda_lbs
    from humaniflow_torch.render import cuda_raster, cuda_tiled
    from humaniflow_torch.utils.profiling import kernel_device_ms, training_screen

    for rows in _forward_rows():
        args = _kernel_args(smpl, (rows,), V, seed=rows)
        records["smpl_verts"][f"forward_device_ms_b{rows}"] = kernel_device_ms(
            lambda: cuda_lbs.smpl_verts(*args), "smpl_verts_kernel", 20)
    for rows in (B, TRAIN_B, TRAIN_B * TRAIN_NJ):
        args = _kernel_args(smpl, (rows,), V, seed=7)
        grad = torch.randn((rows, 3, V), generator=torch.Generator("cuda").manual_seed(8), device="cuda")
        records["smpl_verts_backward"][f"kernel_device_ms_b{rows}"] = kernel_device_ms(
            lambda: cuda_lbs.smpl_verts_backward_vertex(grad, True, True, *args), "smpl_verts_bwd", 20)
    args = _kernel_args(smpl, (B, N), V, seed=2)
    # K1's launch and, when its groups' tails share chunks, the launch adding their sums
    records["smpl_moments"]["device_ms"] = kernel_device_ms(lambda: cuda_lbs.smpl_moments(*args), "moments", 20)
    renderer, sv = training_screen(smpl, TRAIN_B, seed=42)
    attrs = torch.randn((TRAIN_B, renderer.dp["faces"].shape[0], 4), generator=torch.Generator("cuda").manual_seed(44),
                        device="cuda")
    records["raster"]["device_ms"] = kernel_device_ms(  # both passes and their memsets: all the call's device work
        lambda: cuda_raster.raster(sv, renderer.dp["faces"], IMG, attrs=attrs, emit_frags=False, cull_sign=1), "", 20)
    renderer = _vis_renderer("tiled")
    sv = _vis_screen(renderer, smpl, B, seed=71)
    faces = renderer.dp["faces"]
    faces = faces[cuda_tiled.tile_sort_order(sv[0], faces)].contiguous()
    records["tiled_raster"]["device_ms"] = kernel_device_ms(lambda: cuda_tiled.rasterize_tiled(sv, faces, IMG),
                                                            "_kernel", 20)
    print("kernels' device ms per call (torch.profiler): " + json.dumps(
        {"K2 forward": {r: round(records["smpl_verts"][f"forward_device_ms_b{r}"], 5) for r in _forward_rows()},
         "K2 backward kernel": {r: round(records["smpl_verts_backward"][f"kernel_device_ms_b{r}"], 5)
                                for r in (B, TRAIN_B, TRAIN_B * TRAIN_NJ)},
         "K1 (32, 100)": round(records["smpl_moments"]["device_ms"], 5),
         f"K4 B={TRAIN_B}": round(records["raster"]["device_ms"], 5),
         f"K6 B={B}": round(records["tiled_raster"]["device_ms"], 5)}))
    for name, key in (("K1 (32, 100)", "smpl_moments"), (f"K4 B={TRAIN_B} {IMG}²", "raster")):
        rec = records[key]
        print(f"{name}: device {rec['device_ms']:.4f} ms against a bound of {rec['bound_ms']:.4f} ms "
              f"({rec['bound_by']}), {rec['bound_ms'] / rec['device_ms']:.1%} of it")


def _train_batch(b, img, seed, device):
    """A training batch (proxy, targets, 2D joints in pixels) from numpy seed."""
    import numpy as np
    import torch

    from humaniflow_torch.ops import so3_exp

    rng = np.random.default_rng(seed)
    rot = lambda n: so3_exp(torch.from_numpy(rng.normal(scale=0.6, size=(n, 3)).astype(np.float32)))  # noqa: E731
    batch = {
        "proxy": torch.from_numpy(rng.uniform(size=(b, img, img, 18)).astype(np.float32)),
        "pose_rotmats": rot(b * 23).reshape(b, 23, 3, 3),
        "glob_rotmats": rot(b),
        "shape": torch.from_numpy(rng.normal(size=(b, 10)).astype(np.float32)),
        "joints2D": torch.from_numpy(rng.uniform(0, img, size=(b, 17, 2)).astype(np.float32)),
        "joints2D_vis": torch.from_numpy((rng.uniform(size=(b, 17)) > 0.2).astype(np.float32)),
    }
    return {k: v.to(device) for k, v in batch.items()}


def check_train_step_against_cpu(cfg):
    """Phase 11c: one train step on the card against the CPU, same weights,
    batch and noise (B=2, 64², 2 joint samples)."""
    import dataclasses

    import torch

    from humaniflow_torch.models import HumaniflowModel, synthetic_smpl
    from humaniflow_torch.pipelines import make_optimizer, make_train_step

    b, img, nj = 2, 64, 2
    small = dataclasses.replace(cfg, LOSS=dataclasses.replace(cfg.LOSS, NUM_J2D_SAMPLES=nj))
    gpu = HumaniflowModel(small.MODEL, generator=torch.Generator().manual_seed(51))
    cpu = HumaniflowModel(small.MODEL, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    g = torch.Generator().manual_seed(52)
    noise = (torch.randn((b, nj, 10), generator=g), [torch.randn((b, nj, len(p), 3), generator=g) for p in gpu.levels])
    metrics = {}
    for dev, model in (("cuda", gpu), ("cpu", cpu)):
        smpl = synthetic_smpl(num_verts=V, device=dev)
        step = make_train_step(model, smpl, small.LOSS, make_optimizer(model, small), img_wh=img)
        metrics[dev] = step(_train_batch(b, img, 53, dev), noise=(noise[0].to(dev), [z.to(dev) for z in noise[1]]))
    worst_loss = max(abs(float(metrics["cuda"][k]) - float(metrics["cpu"][k])) / abs(float(metrics["cpu"][k]))
                     for k in ("pose_nll", "shape_nll", "joints2D", "glob_rotmats", "total"))
    worst_grad, worst_name = 0.0, None
    for (name, p), q in zip(gpu.named_parameters(), cpu.parameters()):
        rel = float((p.grad.cpu() - q.grad).abs().max() / q.grad.abs().max().clamp(min=1e-30))
        if rel > worst_grad:
            worst_grad, worst_name = rel, name
    # flow BatchNorm running statistics, after Adam's step and their update
    stats = [float((p.detach().cpu() - q.detach()).abs().max() / q.detach().abs().max())
             for (name, p), q in zip(gpu.named_parameters(), cpu.parameters()) if name.endswith(("moving_mean", "moving_var"))]
    nf = small.MODEL.NORM_FLOW
    print(f"train step on GPU vs CPU ({nf.TRANSFORM_TYPE}/{nf.PERMUTE_TYPE}, BatchNorm {nf.BATCH_NORM}; B={b}, "
          f"{img}², {nj} joint samples): loss terms within {worst_loss:.3e} relative, gradients within "
          f"{worst_grad:.3e} of each tensor's largest ({worst_name})"
          + (f", {len(stats)} running-statistics tensors within {max(stats):.3e}" if stats else ""))
    if not (worst_loss <= LOSS_RTOL and worst_grad <= GRAD_RTOL and all(x <= BN_STATS_RTOL for x in stats)):
        raise AssertionError("the train step on the card disagrees with the CPU")


class _StagedDataset:
    """epoch_batches over one staged batch of poses, textures and
    backgrounds, n times."""

    def __init__(self, inputs, n):
        self.inputs, self.n = dict(zip(("pose", "texture", "background"), inputs)), n

    def epoch_batches(self, batch_size):
        for _ in range(self.n):
            yield self.inputs


def train_full_width(smpl, cfg):
    """Phase 11d-e: the synthetic batch and train steps at B=72 with the
    training renderer, then a short train_humaniflow run; returns (counted
    launches by path, timings)."""
    import math
    import os
    import pickle
    import tempfile

    import numpy as np
    import torch

    from humaniflow_torch.data.augmentation import Draws
    from humaniflow_torch.models import HumaniflowModel
    from humaniflow_torch.pipelines import make_optimizer, make_synth_data_fn, make_train_step, train_humaniflow
    from humaniflow_torch.utils.profiling import wall_ms

    renderer = _training_renderer()
    rng = np.random.default_rng(61)
    host = {
        "pose": rng.normal(scale=0.3, size=(TRAIN_B, 72)).astype(np.float32),
        "texture": rng.random(size=(TRAIN_B, 1200, 800, 3), dtype=np.float32),
        "background": rng.random(size=(TRAIN_B, IMG, IMG, 3), dtype=np.float32),
    }
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    inputs = [torch.from_numpy(host[k]).cuda() for k in ("pose", "texture", "background")]
    torch.cuda.synchronize()
    upload_ms = 1e3 * (time.perf_counter() - t0)
    nbytes = sum(a.nbytes for a in host.values())

    model = HumaniflowModel(cfg.MODEL, generator=torch.Generator().manual_seed(0))
    opt = make_optimizer(model, cfg)
    step = make_train_step(model, smpl, cfg.LOSS, opt, img_wh=IMG)
    synth = make_synth_data_fn(cfg, smpl, renderer)
    gen = torch.Generator("cuda").manual_seed(62)
    draws = Draws(gen)
    launches = {}

    _zero_counts()
    batch = synth(draws, *inputs)
    launches["synth batch"] = _read_counts()
    shapes = {"proxy": (TRAIN_B, IMG, IMG, 18), "pose_rotmats": (TRAIN_B, 23, 3, 3), "glob_rotmats": (TRAIN_B, 3, 3),
              "shape": (TRAIN_B, 10), "joints2D": (TRAIN_B, 17, 2), "joints2D_vis": (TRAIN_B, 17),
              "rgb_in": (TRAIN_B, IMG, IMG, 3)}
    for k, shape in shapes.items():
        if tuple(batch[k].shape) != shape or not bool(torch.isfinite(batch[k]).all()):
            raise AssertionError(f"synth batch: {k} has shape {tuple(batch[k].shape)} (expected {shape}) or is not finite")
    if int(batch["binning_overflow"]) != 0:
        raise AssertionError(f"the training render dropped {int(batch['binning_overflow'])} faces")
    print(f"synth batch B={TRAIN_B}: {float(batch['joints2D_vis'].mean()):.3f} of the joints visible, "
          f"proxy edge share {float((batch['proxy'][..., 0] > 0).float().mean()):.4f}, "
          f"heatmap max {float(batch['proxy'][..., 1:].max()):.3f}")

    _zero_counts()
    losses = []
    for _ in range(5):
        b = synth(draws, *inputs)
        b.pop("rgb_in"), b.pop("binning_overflow")
        m = step(b, generator=gen)
        losses.append((float(m["total"]), float(m["nan_skipped"]), float(m["grad_norm"])))
    launches["train steps x5 (synth + step)"] = _read_counts()
    print("train steps on fresh batches (total, nan_skipped, grad_norm): "
          + ", ".join(f"({a:.2f}, {b:.0f}, {c:.1f})" for a, b, c in losses))
    if not all(math.isfinite(a) and b == 0.0 and math.isfinite(c) for a, b, c in losses):
        raise AssertionError("a train step gave a non-finite loss or was skipped")

    batch.pop("rgb_in"), batch.pop("binning_overflow")
    same_noise = torch.Generator("cuda")  # the same sample noise every step
    fixed = [float(step(batch, generator=same_noise.manual_seed(63))["total"]) for _ in range(10)]
    print(f"10 steps on one fixed batch and noise: loss {fixed[0]:.3f} → {fixed[-1]:.3f}")
    if not all(math.isfinite(x) for x in fixed) or not fixed[-1] < fixed[0]:
        raise AssertionError("10 steps on one fixed batch did not lower its loss")

    synth_ms = wall_ms(lambda: synth(draws, *inputs), 3)
    step_ms = wall_ms(lambda: step(batch, generator=gen), 3)
    timings = dict(upload_ms=upload_ms, upload_gb=nbytes / 1e9, synth_ms=synth_ms, step_ms=step_ms,
                   launches_per_step={k: v / 5 for k, v in launches["train steps x5 (synth + step)"].items()})
    print(f"training B={TRAIN_B} {IMG}² N_j2d={TRAIN_NJ}: upload of poses, textures and backgrounds {upload_ms:.1f} ms "
          f"({nbytes / 1e9:.3f} GB); synth {synth_ms:.2f} ms, step {step_ms:.2f} ms per batch; "
          f"{1e3 / (synth_ms + step_ms):.3f} steps/s, {TRAIN_B * 1e3 / (synth_ms + step_ms):.1f} img/s; "
          f"kernel launches per step {timings['launches_per_step']}")

    with tempfile.TemporaryDirectory() as exp:
        _zero_counts()
        params, _ = train_humaniflow(model, smpl, cfg, renderer, _StagedDataset(inputs, 2), _StagedDataset(inputs, 1),
                                     exp, optimizer=opt, num_epochs=1, steps_per_epoch=2, generator=gen)
        launches["train_humaniflow (2 train + 1 val steps)"] = _read_counts()
        with open(os.path.join(exp, "log.pkl"), "rb") as f:
            history = pickle.load(f)
        if not os.path.exists(os.path.join(exp, "epoch_000000.pt")):
            raise AssertionError("train_humaniflow wrote no checkpoint")
        ckpt = torch.load(os.path.join(exp, "epoch_000000.pt"), map_location="cpu", weights_only=False)
        if not torch.equal(ckpt["params"]["fc1.weight"], params["fc1.weight"].cpu()):
            raise AssertionError("the checkpoint does not hold the final parameters")
    print(f"train_humaniflow, 1 epoch (2 train + 1 val steps): train loss {history['train_losses'][-1]:.3f}, "
          f"val loss {history['val_losses'][-1]:.3f}, val PVE-SC {history['val_PVE-SC'][-1]:.4f}; checkpoint written")
    if not all(math.isfinite(h[-1]) for h in (history["train_losses"], history["val_losses"], history["val_PVE-SC"])):
        raise AssertionError("train_humaniflow recorded a non-finite loss or metric")
    for path, c in launches.items():
        if c["raster"] == 0 or c["smpl_verts"] == 0:
            raise AssertionError(f"{path} did not launch K4 and K2: {c}")
        if "step" in path and c["smpl_verts_backward"] == 0:
            raise AssertionError(f"{path} did not run K2's backward: {c}")
    return launches, timings


def _vis_renderer(rasterizer):
    """The visualisation renderer (orthographic, 256²) with the given
    backend; the tiled one must stay tiled on the card."""
    from humaniflow_torch.render import TexturedIUVRenderer

    renderer = TexturedIUVRenderer(img_wh=IMG, projection_type="orthographic", rasterizer=rasterizer)
    if renderer.rasterizer != rasterizer:
        raise AssertionError(f"the {rasterizer} renderer routed to {renderer.rasterizer}")
    return renderer


def _vis_screen(renderer, smpl, b, seed):
    """DensePose-vertex screen coordinates of b synthetic bodies as the
    visualisation renders them: poses 0.25·N(0, 1), flipped by the x-axis π
    rotation, weak-perspective camera (0.9, ±0.05, ±0.05), depth offset 2.5."""
    import math

    import torch

    from humaniflow_torch.models import smpl_forward
    from humaniflow_torch.ops import aa_rotate_translate_points, so3_exp

    g = torch.Generator("cuda").manual_seed(seed)
    x_axis = torch.tensor([1.0, 0.0, 0.0], device="cuda")
    with torch.inference_mode():
        pose = so3_exp(0.25 * torch.randn((b, 24, 3), generator=g, device="cuda"))
        shape = torch.randn((b, 10), generator=g, device="cuda")
        verts = smpl_forward(smpl, shape, pose[:, 1:], pose[:, 0])["vertices"]
        verts = aa_rotate_translate_points(verts, x_axis, math.pi, torch.zeros(3, device="cuda"))
        t = 0.05 * (2 * torch.rand((b, 2), generator=g, device="cuda") - 1)
        cam_t = torch.cat([t, torch.full((b, 1), 2.5, device="cuda")], dim=-1)
        return renderer._screen_verts(verts[:, renderer.dp["vertex_map"]], cam_t,
                                      torch.full((b, 2), 0.9, device="cuda")).contiguous()


def _tiled_ragged(img):
    """Hand-made faces for K6 on two meshes: ordinary, zero-area, off screen,
    crossing the borders, stretched, with vertices on the culling tiles'
    borders, a square split along its diagonal (ties on the shared edge), a
    duplicated face (an exact tie) and a NaN depth, padded to one 64-face
    chunk with copies of the first face; the second chunk holds two faces
    with a NaN x and an ordinary face, and is culled everywhere."""
    import math

    import torch

    v = torch.tensor(
        [[3.2, 4.1, 0.0], [17.9, 6.3, 0.0], [8.0, 21.7, 0.0],
         [30.5, 30.5, 0.0], [40.5, 40.5, 0.0], [50.5, 50.5, 0.0],
         [-90.0, -80.0, 0.0], [-60.0, -85.0, 0.0], [-70.0, -50.0, 0.0],
         [-20.0, 100.0, 0.0], [img + 30.0, 110.0, 0.0], [img / 2, 150.0, 0.0],
         [1.5, img - 2.5, 0.0], [img - 1.5, img - 2.0, 0.0], [img / 2, img - 1.0, 0.0],
         [128.0, 20.0, 1.0], [140.5, 32.0, 1.0], [128.0, 44.0, 1.0],
         [40.0, 40.0, 1.0], [80.0, 40.0, 1.0], [80.0, 80.0, 1.0], [40.0, 80.0, 1.0],
         [20.0, 90.0, math.nan], [60.0, 95.0, 0.5], [30.0, 120.0, 0.5],
         [math.nan, 10.0, 0.0], [20.0, 10.0, 0.0], [15.0, 30.0, 0.0]],
        device="cuda",
    )
    first = [[0, 1, 2], [3, 4, 5], [6, 7, 8], [9, 10, 11], [12, 13, 14]]
    first += [f[::-1] for f in first] + [[15, 16, 17], [18, 19, 20], [18, 20, 21], [18, 20, 21], [22, 23, 24]]
    first += [[0, 1, 2]] * (64 - len(first))
    faces = torch.tensor(first + [[25, 26, 27], [27, 26, 25], [0, 1, 2]], dtype=torch.int32, device="cuda")
    return torch.stack([v, v + torch.tensor([0.37, 0.37, 0.25], device="cuda")]).contiguous(), faces


def _tiled_live_pairs(sv, faces, img):
    """The (mesh, tile, chunk) triples K6 walks for these inputs: the 64-face
    chunks whose bounds meet a 32×128 tile (a diagnostic of the culling, not
    of the work the function needs)."""
    import torch

    from humaniflow_torch.render.cuda_tiled import BLOCK_COLS, BLOCK_ROWS, _chunk_bounds

    ymin, ymax, xmin, xmax = _chunk_bounds(sv[:, faces.long()], faces.shape[0])
    row0 = (torch.arange(img // BLOCK_ROWS, device=sv.device) * BLOCK_ROWS).float()[:, None]
    col0 = (torch.arange(img // BLOCK_COLS, device=sv.device) * BLOCK_COLS).float()[None, :]
    e = lambda t: t[..., None, None]  # noqa: E731
    live = ((e(ymax) >= row0) & (e(ymin) <= row0 + BLOCK_ROWS) & (e(xmax) >= col0) & (e(xmin) <= col0 + BLOCK_COLS))
    return int(live.sum())


def check_tiled_raster(smpl):
    """Phase 12: K6 against its plain twin, bit for bit, and its time at the
    visualisation batch; returns its record."""
    import torch

    from humaniflow_torch.render import cuda_tiled
    from humaniflow_torch.utils.profiling import cuda_ms, sliver_case

    renderer = _vis_renderer("tiled")
    faces = renderer.dp["faces"]
    sv = _vis_screen(renderer, smpl, B, seed=71)
    sorted_faces = faces[cuda_tiled.tile_sort_order(sv[0], faces)].contiguous()
    cases = [(f"{B} posed bodies, tile-sorted faces", IMG, sv, sorted_faces)]
    cases += [(f"ragged faces at {img}²", img, *_tiled_ragged(img)) for img in (128, 384)]
    # near-degenerate faces whose rounding claims pixels beyond their boxes:
    # the cull inside the chunks must skip none that the formula keeps
    cases.append((f"sliver stress, 2,400 faces at {IMG}²", IMG, *sliver_case(IMG)))
    for name, img, s, f in cases:
        got = cuda_tiled.rasterize_tiled(s, f, img)
        torch.cuda.synchronize()
        want = cuda_tiled.rasterize_tiled_plain(s, f, img)
        diff = (int((got.face_idx != want.face_idx).sum()) + int((got.depth != want.depth).sum())
                + int((got.bary != want.bary).sum()))
        covered = int(want.mask.sum())
        print(f"K6 tiled_raster, {name}: {diff} differing values, {covered} covered px")
        if diff or covered == 0:
            raise AssertionError(f"K6 disagrees with its plain twin ({name})")
    # the z-buffer's work: the pixels of each finite, non-degenerate face's
    # widened, clipped box (as K3's and K4's bounds count it); the culling's
    # live (tile, chunk) pairs are reported beside it
    tests, kept = _coverage_work(sv, sorted_faces, IMG, 0)
    live = _tiled_live_pairs(sv, sorted_faces, IMG)
    pairs = B * -(-faces.shape[0] // cuda_tiled.FACE_CHUNK) * (IMG // 32) * (IMG // 128)
    flops = TILED_TEST_OPS * tests
    nbytes = 4 * (sv.numel() + sorted_faces.numel()) + B * IMG * IMG * 4 * 5
    bound, by = _bound_ms(flops, nbytes)
    ms = cuda_ms(lambda: cuda_tiled.rasterize_tiled(sv, sorted_faces, IMG), 20)
    plain_ms = cuda_ms(lambda: cuda_tiled.rasterize_tiled_plain(sv[:2], sorted_faces, IMG), 2)
    print(f"K6 at B={B}, {IMG}²: {tests:.4e} pixel tests over {kept} kept faces; {live} live (tile, chunk) "
          f"pairs of {pairs}, "
          f"{nbytes / 1e6:.1f} MB; {ms:.4f} ms per call against a bound of {bound:.4f} ms ({by}); "
          f"twin {plain_ms:.2f} ms on 2 meshes")
    return dict(name="tiled_raster", replaces="humaniflow_tpu/render/pallas_rasterizer.py:41", max_abs_err=0.0,
                ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by, ms_meshes=B, plain_ms_meshes=2,
                live_pairs=live, all_pairs=pairs)


def time_figure_launches(draw, renderer):
    """K6 in a figure's own launches: CUDA events around each call of
    rasterize_tiled that the tiled renderer makes in one draw (they also
    span the wrapper's host time where the card waits on it), with each
    launch's meshes and bound.  Returns [(meshes, ms, bound ms)]."""
    import torch

    from humaniflow_torch.render import renderer as renderer_module

    real = renderer_module.rasterize_tiled
    calls = []

    def timed(screen, faces, img):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = real(screen, faces, img)
        end.record()
        calls.append((screen, faces, img, start, end))
        return out

    draw(renderer)  # warm-up
    renderer_module.rasterize_tiled = timed
    try:
        draw(renderer)
    finally:
        renderer_module.rasterize_tiled = real
    torch.cuda.synchronize()
    out = []
    for screen, faces, img, start, end in calls:
        tests, _ = _coverage_work(screen, faces, img, 0)
        nbytes = 4 * (screen.numel() + faces.numel()) + screen.shape[0] * img * img * 4 * 5
        out.append((screen.shape[0], start.elapsed_time(end), _bound_ms(TILED_TEST_OPS * tests, nbytes)[0]))
    return out


def check_lbs_skin():
    """Phase 13: K7 against its plain twin and its gradient against autograd
    of the twin; returns its record."""
    import torch

    from humaniflow_torch.models import cuda_lbs
    from humaniflow_torch.utils.profiling import cuda_ms

    g = torch.Generator("cuda").manual_seed(81)
    w = torch.softmax(3.0 * torch.randn((V, 24), generator=g, device="cuda"), -1)
    worst = 0.0
    for rows in (37, B * N):
        a12 = 0.5 * torch.randn((rows, 24, 12), generator=g, device="cuda")
        posed = torch.randn((rows, 3, V), generator=g, device="cuda")
        got = cuda_lbs.lbs_skin_cm(w, a12, posed)
        torch.cuda.synchronize()
        err = float((got - cuda_lbs.lbs_skin_cm_plain(w, a12, posed)).abs().max())
        worst = max(worst, err)
        print(f"K7 lbs_skin rows={rows} V={V}: max_abs_err {err:.3e}")
        if not err <= LBS_ATOL:
            raise AssertionError(f"K7 disagrees with its plain twin at rows={rows}: {err} > {LBS_ATOL}")
    leaves = [t.detach().clone().requires_grad_(True) for t in (w, a12[:TRAIN_B], posed[:TRAIN_B])]
    cot = torch.randn((TRAIN_B, 3, V), generator=g, device="cuda")
    got = torch.autograd.grad(cuda_lbs.LBSSkin.apply(*leaves), leaves, cot)
    want = torch.autograd.grad(cuda_lbs.lbs_skin_cm_plain(*leaves), leaves, cot)
    rel = max(float((a - b).abs().max() / b.abs().max()) for a, b in zip(got, want))
    print(f"K7 with its gradient (LBSSkin), rows={TRAIN_B}: {rel:.3e} of the largest gradient from autograd of "
          f"the twin")
    if not rel <= LBS_GRAD_RTOL:
        raise AssertionError(f"LBSSkin's gradient disagrees with autograd of the twin: {rel}")
    rows = B * N
    flops = 2 * LBS_FMAS * rows * V
    nbytes = 4 * (2 * posed.numel() + w.numel() + a12.numel())
    bound, by = _bound_ms(flops, nbytes)
    ms = cuda_ms(lambda: cuda_lbs.lbs_skin_cm(w, a12, posed), 20)
    plain_ms = cuda_ms(lambda: cuda_lbs.lbs_skin_cm_plain(w, a12, posed), 5)
    bwd_ms = cuda_ms(lambda: cuda_lbs.lbs_skin_backward(cot, (True, True, True), *[t.detach() for t in leaves]), 5)
    print(f"K7 at rows={rows}, V={V}: {ms:.4f} ms against a bound of {bound:.4f} ms ({by}); twin (einsum and FMA "
          f"chain) {plain_ms:.4f} ms; backward at rows={TRAIN_B} {bwd_ms:.4f} ms")
    return dict(name="lbs_skin", replaces="humaniflow_tpu/models/pallas_lbs.py:30", max_abs_err=worst, ms=ms,
                plain_ms=plain_ms, library_ms=None, bound_ms=bound, bound_by=by, ms_rows=rows,
                backward_ms_b72=bwd_ms, gradient_rel_err=rel)


def _optimise_init(pred, smpl, seed, device="cuda"):
    """Targets and init for the optimise path, from predict's outputs: the
    ground truth is each image's point estimate (shape mode, pose, global
    rotation, camera); the target 2D joints are its projected COCO joints
    (x-flip, weak perspective, pixels); the init is the ground truth with
    shape + 0.2 and pose + 0.15·N(0, 1); every joint visible."""
    import math

    import torch

    from humaniflow_torch.data.label_conversions import ALL_JOINTS_TO_COCO_MAP
    from humaniflow_torch.metrics.train_metrics import undo_keypoint_normalisation
    from humaniflow_torch.models import smpl_forward
    from humaniflow_torch.ops import orthographic_project, so3_exp

    b = pred["shape_mode"].shape[0]
    g = torch.Generator(device).manual_seed(seed)
    with torch.inference_mode():
        shape, pose = pred["shape_mode"].to(device), pred["pose_axisangle_point_est"].to(device)
        glob, cam = pred["glob_rotmat"].to(device), pred["cam_wp"].to(device)
        flip = so3_exp(torch.tensor([[math.pi, 0.0, 0.0]], device=device))[0]
        joints = smpl_forward(smpl, shape, so3_exp(pose), glob)["joints"][:, ALL_JOINTS_TO_COCO_MAP]
        target = undo_keypoint_normalisation(orthographic_project(torch.einsum("ij,bkj->bki", flip, joints), cam),
                                             IMG)
        return {
            "shape": shape + 0.2, "pose_axisangle": pose + 0.15 * torch.randn(pose.shape, generator=g, device=device),
            "glob_rotmat": glob, "cam_wp": cam, "input_feats": pred["input_feats"].to(device),
            "joints2D": target, "joints2D_conf": torch.ones((b, 17), device=device),
        }


def check_optimise_against_cpu(model, cfg, init):
    """GPU against CPU: the optimisation of the first 2 images for 3
    iterations, same weights and init."""
    import dataclasses

    from humaniflow_torch.configs import get_optimise_cfg_defaults
    from humaniflow_torch.models import HumaniflowModel, synthetic_smpl
    from humaniflow_torch.pipelines import optimise_batch_with_humaniflow_prior

    ocfg = dataclasses.replace(get_optimise_cfg_defaults(), NUM_ITERS=3)
    cpu_model = HumaniflowModel(cfg.MODEL, device="cpu")
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    small = {k: v[:2] for k, v in init.items()}
    outs = {}
    for dev, mdl in (("cuda", model), ("cpu", cpu_model)):
        outs[dev] = optimise_batch_with_humaniflow_prior(mdl, synthetic_smpl(num_verts=V, device=dev), ocfg,
                                                         {k: v.to(dev) for k, v in small.items()}, img_wh=IMG,
                                                         device=dev)
    state = max(float((outs["cuda"][k].cpu() - outs["cpu"][k]).abs().max() / outs["cpu"][k].abs().max())
                for k in ("pose_axisangle", "glob_axisangle", "shape", "cam_wp"))
    loss = max(abs(float(outs["cuda"][w][k]) - float(outs["cpu"][w][k])) / abs(float(outs["cpu"][w][k]))
               for w in ("initial_losses", "final_losses") for k in outs["cpu"][w])
    print(f"optimise on GPU vs CPU (B=2, 3 iterations): state within {state:.3e} of each tensor's largest, "
          f"losses within {loss:.3e} relative")
    if not (state <= OPT_STATE_RTOL and loss <= OPT_LOSS_RTOL):
        raise AssertionError("the optimisation on the card disagrees with the CPU")


class _RecordingRenderer:
    """Wraps a renderer and keeps every output of every call (on the card)."""

    def __init__(self, renderer):
        self.renderer, self.outputs = renderer, []

    def __call__(self, *args, **kwargs):
        out = self.renderer(*args, **kwargs)
        self.outputs.append(out)
        return out


def _compare_renders(name, tiled_outputs, xla_outputs):
    """Masks and depth equal on every pixel; IUV and RGB differ only where a
    tie picked another face, on at most TIE_SHARE of the covered pixels.
    Returns (differing px, covered px)."""
    import torch

    differ = covered = 0
    for a, b in zip(tiled_outputs, xla_outputs, strict=True):
        if not torch.equal(a["silhouettes"], b["silhouettes"]) or not torch.equal(a["depth_images"],
                                                                                  b["depth_images"]):
            raise AssertionError(f"{name}: the tiled render's masks or depth differ from the exact scan's")
        px = (a["iuv_images"] != b["iuv_images"]).any(-1) | (a["rgb_images"] != b["rgb_images"]).any(-1)
        differ += int(px.sum())
        covered += int(b["silhouettes"].sum())
    print(f"{name}, tiled (K6) vs exact scan: masks and depth equal; IUV or RGB differ on {differ} of {covered} "
          f"covered px (ties)")
    if differ > TIE_SHARE * covered or covered == 0:
        raise AssertionError(f"{name}: {differ} px differ, more than {TIE_SHARE} of {covered} covered px")
    return differ, covered


def optimise_and_visualise(model, smpl, cfg, pred):
    """Phase 14: the optimise path at full width, then the figures through
    the tiled renderer against the exact scan; returns (launches by path,
    timings)."""
    import math

    import numpy as np
    import torch

    from humaniflow_torch.configs import get_optimise_cfg_defaults
    from humaniflow_torch.models import smpl_forward
    from humaniflow_torch.ops import aa_rotate_translate_points, so3_exp
    from humaniflow_torch.pipelines import make_optimise_fn
    from humaniflow_torch.utils.profiling import wall_ms
    from humaniflow_torch.utils.sampling import joints2d_error_sorted_verts_sampling
    from humaniflow_torch.utils.visualise import (
        render_point_est_visualisation,
        render_samples_visualisation,
        uncertainty_colourmap,
    )

    ocfg = get_optimise_cfg_defaults()
    init = _optimise_init(pred, smpl, seed=91)
    check_optimise_against_cpu(model, cfg, init)
    optimise = make_optimise_fn(model, smpl, ocfg, img_wh=IMG)
    launches = {}
    _zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = optimise(init)
    torch.cuda.synchronize()
    loop_ms = 1e3 * (time.perf_counter() - t0)
    launches[f"optimise ({ocfg.NUM_ITERS} iterations)"] = counts = _read_counts()
    first, last = out["initial_losses"], out["final_losses"]
    print(f"optimise B={B}, {ocfg.NUM_ITERS} iterations, LR {ocfg.LR}: halted {bool(out['halted_on_nan'])}; "
          + ", ".join(f"{k} {float(first[k]):.4f} → {float(last[k]):.4f}" for k in first)
          + f"; {loop_ms:.1f} ms ({loop_ms / ocfg.NUM_ITERS:.2f} ms per iteration); kernel launches {counts}")
    if bool(out["halted_on_nan"]):
        raise AssertionError("the optimisation halted on a non-finite update")
    if not all(math.isfinite(float(v)) for w in (first, last) for v in w.values()):
        raise AssertionError("a loss of the optimisation is not finite")
    if not float(last["joints2D"]) < float(first["joints2D"]):
        raise AssertionError("the optimisation did not lower the 2D joint loss")
    if counts["smpl_verts"] == 0 or counts["smpl_verts_backward"] == 0:
        raise AssertionError(f"the optimisation did not run K2 and its gradient: {counts}")

    with torch.inference_mode():
        verts = smpl_forward(smpl, out["shape"], so3_exp(out["pose_axisangle"]), so3_exp(out["glob_axisangle"]))
        x_axis, zero = torch.tensor([1.0, 0.0, 0.0], device="cuda"), torch.zeros(3, device="cuda")
        flip = lambda v: aa_rotate_translate_points(v, x_axis, math.pi, zero)  # noqa: E731
        verts_flipped, tpose_flipped = flip(verts["vertices"]), flip(pred["tpose_verts"])
        sorted_samples = flip(joints2d_error_sorted_verts_sampling(
            pred["verts_samples"][0], pred["joints_samples"][0], pred["proxy_rep"][:1, :, :, 1:].permute(0, 3, 1, 2),
            pred["cam_wp"][:1])[:VIS_SAMPLES])
    colours = np.stack([uncertainty_colourmap(v) for v in pred["vertex_uncertainty_l2"].cpu().numpy()])
    figures = {
        "point-estimate figure": lambda r: render_point_est_visualisation(
            r, verts_flipped, out["cam_wp"], tpose_vertices=tpose_flipped, vertex_colours=colours),
        "sample renders": lambda r: render_samples_visualisation(r, sorted_samples, pred["cam_wp"][:1]),
    }
    renderers = {name: _vis_renderer(name) for name in ("tiled", "xla")}
    timings = dict(optimise_ms=loop_ms, optimise_ms_per_iter=loop_ms / ocfg.NUM_ITERS)
    for fig, draw in figures.items():
        recorded = {}
        for name, r in renderers.items():
            rec = _RecordingRenderer(r)
            _zero_counts()
            result = draw(rec)
            counts = _read_counts()
            if name == "tiled":
                launches[f"visualisation: {fig}, tiled"] = counts
                if counts["tiled_raster"] != len(rec.outputs):
                    raise AssertionError(f"{fig}: K6 launched {counts['tiled_raster']} times for "
                                         f"{len(rec.outputs)} renders")
            recorded[name] = rec.outputs
            image = result["figure"] if isinstance(result, dict) else result
            if not np.isfinite(image).all():
                raise AssertionError(f"{fig} ({name}) is not finite")
        _compare_renders(fig, recorded["tiled"], recorded["xla"])
        timings[fig] = {name: wall_ms(lambda: draw(r), 3 if name == "tiled" else 1) for name, r in renderers.items()}
        timings[fig]["k6_launches"] = k6 = time_figure_launches(draw, renderers["tiled"])
        print(f"{fig}: tiled (K6) {timings[fig]['tiled']:.2f} ms, exact scan {timings[fig]['xla']:.2f} ms; K6 in its "
              f"{len(k6)} launches: " + ", ".join(f"{m} meshes {ms:.4f} ms (bound {bd:.4f})" for m, ms, bd in k6))
    return launches, timings


def profile_optimise(model, smpl, pred):
    """Device busy ms, launches and the idle share of one optimise iteration
    (the difference of a 5- and a 1-iteration run)."""
    import dataclasses

    from humaniflow_torch.configs import get_optimise_cfg_defaults
    from humaniflow_torch.pipelines import make_optimise_fn
    from humaniflow_torch.utils.profiling import device_profile, wall_ms

    init = _optimise_init(pred, smpl, seed=91)
    res = {}
    for iters in (1, 5):
        fn = make_optimise_fn(model, smpl, dataclasses.replace(get_optimise_cfg_defaults(), NUM_ITERS=iters),
                              img_wh=IMG)
        res[iters] = (wall_ms(lambda: fn(init), 3), device_profile(lambda: fn(init), iters=2))
    wall = (res[5][0] - res[1][0]) / 4
    busy = (res[5][1]["device_busy_ms"] - res[1][1]["device_busy_ms"]) / 4
    launches = (res[5][1]["launches"] - res[1][1]["launches"]) / 4
    print(f"optimise iteration at B={B}: wall {wall:.2f} ms, device busy {busy:.2f} ms, idle share "
          f"{1.0 - busy / wall:.3f}, {launches:.0f} kernel launches; top kernels of the 5-iteration run "
          f"{res[5][1]['top_kernels_ms'][:4]}")


MENU = (  # phase 15a: non-default flows of the JAX factory's menu (transform, permute, flow BatchNorm)
    ("affine_coupling", "conditional_linear_plu", True),
    ("spline_masked", "linear_plu", False),
    ("affine_masked", "permute", False),
)
MENU_STEPS = 3  # train steps per menu configuration
BN_STATS_RTOL = 1e-5  # GPU vs CPU train step: flow BatchNorm running statistics after the step
TRAIN_POSES, VAL_POSES = 144, 72  # phase 15b: two train and one val batch an epoch at B=72
EVAL_FRAMES = 32  # phase 15c: one batch of each protocol


def _menu_cfg(cfg, transform_type, permute_type, batch_norm):
    import dataclasses

    nf = dataclasses.replace(cfg.MODEL.NORM_FLOW, TRANSFORM_TYPE=transform_type, PERMUTE_TYPE=permute_type,
                             BATCH_NORM=batch_norm)
    return dataclasses.replace(cfg, MODEL=dataclasses.replace(cfg.MODEL, NORM_FLOW=nf))


def flow_menu(smpl, cfg, proxy, default_timings):
    """Phase 15a: each menu configuration at full width, on the default
    route (K5 refuses these flows, so they run eager):
    distribution inference at B=32, N=100 and MENU_STEPS train steps at
    B=72, 256² through the training renderer; then one train step GPU
    against CPU with flow BatchNorm.  Returns the counted launches by path."""
    import math

    import torch

    from humaniflow_torch.data.augmentation import Draws
    from humaniflow_torch.flows import cuda_level
    from humaniflow_torch.models import HumaniflowModel, smpl_forward, smpl_vertex_moments
    from humaniflow_torch.pipelines import make_optimizer, make_synth_data_fn, make_train_step
    from humaniflow_torch.utils.profiling import wall_ms

    renderer = _training_renderer()
    gen = torch.Generator("cuda").manual_seed(71)
    inputs = [torch.rand(shape, generator=gen, device="cuda") for shape in
              ((TRAIN_B, 72), (TRAIN_B, 1200, 800, 3), (TRAIN_B, IMG, IMG, 3))]
    inputs[0] = (inputs[0] - 0.5) * 0.6
    default_ms = default_timings["synth_ms"] + default_timings["step_ms"]
    launches = {}
    _set_fused(True)
    for variant in MENU:
        name = "/".join(str(v) for v in variant[:2]) + (" + BatchNorm" if variant[2] else "")
        vcfg = _menu_cfg(cfg, *variant)
        model = HumaniflowModel(vcfg.MODEL, generator=torch.Generator().manual_seed(72))
        if cuda_level.supports_flow(model.flow):
            raise AssertionError(f"{name}: K5 accepts a flow it does not hold")

        _zero_counts()
        with torch.inference_mode():
            out = model.apply(proxy, generator=torch.Generator("cuda").manual_seed(73), num_samples=N,
                              use_shape_mode_for_samples=True)
            mom = smpl_vertex_moments(
                smpl, out["shape_samples"].reshape(B * N, -1), out["pose_rotmats_samples"].reshape(B * N, 23, 3, 3),
                out["glob_rotmat"][:, None].expand(B, N, 3, 3).reshape(B * N, 3, 3), num_groups=B)
            verts = smpl_forward(smpl, out["shape_mode"], out["pose_rotmats_point_est"], out["glob_rotmat"])["vertices"]
        c = launches[f"distribution inference, {name}"] = _read_counts()
        if c["smpl_moments"] == 0 or c["smpl_verts"] == 0 or c["flow_level"] != 0:
            raise AssertionError(f"{name}: distribution inference launched {c}")
        var = torch.clamp(mom[:, 1] / N - (mom[:, 0] / N) ** 2, min=0.0).sum(1)
        if not (bool(torch.isfinite(var).all()) and bool(torch.isfinite(verts).all()) and float(var.max()) > 0):
            raise AssertionError(f"{name}: non-finite or zero vertex variance")

        opt = make_optimizer(model, vcfg)
        step = make_train_step(model, smpl, vcfg.LOSS, opt, img_wh=IMG)
        synth = make_synth_data_fn(vcfg, smpl, renderer)
        draws = Draws(gen)
        stats = {k: p.detach().clone() for k, p in model.named_parameters() if k.endswith(("moving_mean", "moving_var"))}
        _zero_counts()
        losses = []
        for _ in range(MENU_STEPS):
            batch = synth(draws, *inputs)
            batch.pop("rgb_in"), batch.pop("binning_overflow")
            m = step(batch, generator=gen)
            losses.append((float(m["total"]), float(m["nan_skipped"])))
        c = launches[f"train steps x{MENU_STEPS} (synth + step), {name}"] = _read_counts()
        if c["raster"] == 0 or c["smpl_verts"] == 0 or c["smpl_verts_backward"] == 0 or c["flow_level"] != 0:
            raise AssertionError(f"{name}: train steps launched {c}")
        if not all(math.isfinite(a) and b == 0.0 for a, b in losses):
            raise AssertionError(f"{name}: a train step gave a non-finite loss or was skipped: {losses}")
        moved = {k: float((p.detach() - stats[k]).abs().max()) for k, p in model.named_parameters() if k in stats}
        if variant[2] and not (moved and min(moved.values()) > 0):
            raise AssertionError(f"{name}: the flow BatchNorm running statistics did not move: {moved}")
        synth_ms = wall_ms(lambda: synth(draws, *inputs), 2)
        step_ms = wall_ms(lambda: step(batch, generator=gen), 2)
        print(f"flow menu {name}: distribution inference B={B} N={N} variance max {float(var.max()):.3e}; "
              f"train B={TRAIN_B} {IMG}²: losses {', '.join(f'{a:.2f}' for a, _ in losses)}, synth {synth_ms:.2f} ms, "
              f"step {step_ms:.2f} ms, {TRAIN_B * 1e3 / (synth_ms + step_ms):.1f} img/s (default flow, phase 11: "
              f"{default_timings['step_ms']:.2f} ms a step, {TRAIN_B * 1e3 / default_ms:.1f} img/s)"
              + (f"; BatchNorm statistics moved by {min(moved.values()):.3e}-{max(moved.values()):.3e}"
                 if variant[2] else ""))
        del model, opt, step
    _set_fused(False)
    check_train_step_against_cpu(_menu_cfg(cfg, *MENU[0]))
    return launches


def _write_smpl_npz(path, seed):
    """An SMPL .npz written by the port's converter from a .pkl laid out as
    the released files are (posedirs (V, 3, 207), a scipy-sparse
    J_regressor) holding synthetic_smpl(6890, seed)'s arrays."""
    import pickle

    import numpy as np
    import scipy.sparse

    from humaniflow_torch.models import synthetic_smpl
    from humaniflow_torch.models.smpl import convert_smpl_pkl

    s = synthetic_smpl(num_verts=V, seed=seed, device="cpu")
    with open(path + ".pkl", "wb") as f:
        pickle.dump({"v_template": s.v_template.numpy().astype(np.float64),
                     "shapedirs": s.shapedirs.numpy().astype(np.float64),
                     "posedirs": s.posedirs.numpy().T.reshape(V, 3, -1).astype(np.float64),
                     "J_regressor": scipy.sparse.csc_matrix(s.j_regressor.numpy().astype(np.float64)),
                     "weights": s.lbs_weights.numpy().astype(np.float64), "f": s.faces.numpy().astype(np.uint32)},
                    f, protocol=2)
    convert_smpl_pkl(path + ".pkl", path)


def _write_training_files(root):
    """Poses, textures and JPEG backgrounds (OpenCV) of the train and val
    splits; points configs/paths.py at them."""
    import cv2
    import numpy as np

    from humaniflow_torch.configs import paths

    rng = np.random.default_rng(81)
    prefixes = ("h36m", "up3d", "3dpw", "amass")
    for split, n in (("TRAIN", TRAIN_POSES), ("VAL", VAL_POSES)):
        d = os.path.join(root, split.lower())
        os.makedirs(os.path.join(d, "backgrounds"))
        np.savez(os.path.join(d, "poses.npz"), fnames=np.array([f"{prefixes[i % 4]}_{i:05d}" for i in range(n)]),
                 poses=rng.normal(scale=0.3, size=(n, 72)).astype(np.float32))
        np.savez(os.path.join(d, "textures.npz"), grey=rng.integers(0, 256, (2, 1200, 800, 3), dtype=np.uint8),
                 nongrey=rng.integers(0, 256, (4, 1200, 800, 3), dtype=np.uint8))
        for i in range(16):
            h, w = 240 + 16 * i, 320 - 8 * i
            img = rng.integers(0, 256, (h // 8, w // 8, 3), dtype=np.uint8)
            img = cv2.resize(img, (w, h), interpolation=cv2.INTER_LINEAR)
            cv2.imwrite(os.path.join(d, "backgrounds", f"bg_{i:03d}.jpg"), img)
        setattr(paths, f"{split}_POSES_PATH", os.path.join(d, "poses.npz"))
        setattr(paths, f"{split}_TEXTURES_PATH", os.path.join(d, "textures.npz"))
        setattr(paths, f"{split}_BACKGROUNDS_PATH", os.path.join(d, "backgrounds"))


def _write_eval_sets(root):
    """A 3DPW and an SSP-3D directory of EVAL_FRAMES frames each, as the
    releases lay them out (PNG frames written with OpenCV); points
    configs/paths.py at them."""
    import cv2
    import numpy as np

    from humaniflow_torch.configs import paths

    rng = np.random.default_rng(82)
    n, orig = EVAL_FRAMES, 320
    pw3d = os.path.join(root, "3dpw")
    os.makedirs(os.path.join(pw3d, "cropped_frames"))
    ssp3d = os.path.join(root, "ssp3d")
    for sub in ("images", "silhouettes"):
        os.makedirs(os.path.join(ssp3d, sub))
    for i in range(n):
        img = cv2.resize(rng.integers(0, 256, (orig // 8, orig // 8, 3), dtype=np.uint8), (orig, orig))
        cv2.imwrite(os.path.join(pw3d, "cropped_frames", f"f{i:03d}.png"), img)
        cv2.imwrite(os.path.join(ssp3d, "images", f"s{i:03d}.png"), img)
        sil = np.zeros((orig, orig), np.uint8)
        sil[60 + i:280, 100:220 - i] = 255
        cv2.imwrite(os.path.join(ssp3d, "silhouettes", f"s{i:03d}.png"), sil)
    kp = rng.uniform(20, orig - 20, size=(n, 17, 3)).astype(np.float32)
    kp[:, :, 2] = rng.uniform(0.5, 1.0, size=(n, 17))
    np.save(os.path.join(pw3d, "hrnet_results_centred.npy"), kp)
    np.savez(os.path.join(pw3d, "3dpw_test.npz"), imgname=np.array([f"f{i:03d}.png" for i in range(n)]),
             pose=rng.normal(scale=0.3, size=(n, 72)).astype(np.float32),
             shape=rng.normal(scale=0.5, size=(n, 10)).astype(np.float32), gender=np.array(["m", "f"] * (n // 2)),
             joints2D_coco=kp)
    np.savez(os.path.join(ssp3d, "labels.npz"), fnames=np.array([f"s{i:03d}.png" for i in range(n)]),
             shapes=rng.normal(scale=0.5, size=(n, 10)).astype(np.float32),
             poses=rng.normal(scale=0.3, size=(n, 72)).astype(np.float32), joints2D=kp,
             bbox_centres=np.full((n, 2), orig / 2, np.float32), bbox_whs=np.full((n,), orig * 0.8, np.float32),
             genders=np.array(["m", "f"] * (n // 2)))
    paths.PW3D_PATH, paths.SSP3D_PATH = pw3d, ssp3d


def train_and_evaluate_clis(default_timings, root):
    """Phase 15b-c: the train CLI on the card (two epochs, then a resume for
    a third) on files written at run time into `root`, with the host's share
    timed; then the evaluate CLI on both protocols with the checkpoint it
    wrote.  Returns (the counted launches by path, that checkpoint); the
    files stay in `root` for phase 16."""
    import math
    import pickle

    import numpy as np
    import torch

    from humaniflow_torch.cli import run_evaluate, run_train
    from humaniflow_torch.configs import paths
    from humaniflow_torch.data import native_loader
    from humaniflow_torch.data.datasets import OnTheFlySMPLTrainDataset

    launches = {}
    saved = dict(vars(paths))
    try:
        for gender, seed in (("NEUTRAL", 0), ("MALE", 1), ("FEMALE", 2)):
            npz = os.path.join(root, f"SMPL_{gender}.npz")
            _write_smpl_npz(npz, seed)
            setattr(paths, f"SMPL_{gender}", npz)
        _write_training_files(root)
        if native_loader.native_available():
            print("training backgrounds decoded by the native loader")
        else:
            why = native_loader.build_error().splitlines()
            print("training backgrounds decoded by OpenCV (the native loader: "
                  + next((line for line in why if "error:" in line), why[-1]).strip() + ")")

        data = OnTheFlySMPLTrainDataset(paths.TRAIN_POSES_PATH, paths.TRAIN_TEXTURES_PATH,
                                        paths.TRAIN_BACKGROUNDS_PATH, img_wh=IMG)
        idx = np.arange(TRAIN_B)
        data.sample_batch(idx)
        t0 = time.perf_counter()
        for _ in range(3):
            host = data.sample_batch(idx)
        sample_ms = 1e3 * (time.perf_counter() - t0) / 3
        t0 = time.perf_counter()
        for _ in range(3):
            torch.as_tensor(host["texture"], device="cuda")
        torch.cuda.synchronize()
        upload_ms = 1e3 * (time.perf_counter() - t0) / 3
        backgrounds = [data.backgrounds_paths[i % len(data.backgrounds_paths)] for i in range(TRAIN_B)]
        t0 = time.perf_counter()
        for _ in range(3):
            native_loader.decode_jpeg_batch(backgrounds, IMG)
        decode_ms = 1e3 * (time.perf_counter() - t0) / 3
        nbytes = sum(a.nbytes for a in host.values())
        print(f"host data path B={TRAIN_B}: sample_batch {sample_ms:.1f} ms ({nbytes / 1e6:.0f} MB: textures "
              f"{host['texture'].nbytes / 1e6:.0f} MB float32), of which the background decode {decode_ms:.1f} ms; "
              f"texture upload {upload_ms:.1f} ms; on the card (phase 11) synth {default_timings['synth_ms']:.2f} "
              f"ms, step {default_timings['step_ms']:.2f} ms")

        exp = os.path.join(root, "experiment")
        wall = {}
        for run, argv in (("2 epochs", ["-O", "TRAIN.NUM_EPOCHS", "2", "TRAIN.EPOCHS_PER_SAVE", "1"]),
                          ("resume, epoch 3", ["-R", "1", "-O", "TRAIN.NUM_EPOCHS", "3"])):
            _zero_counts()
            t0 = time.perf_counter()
            run_train.main(["-E", exp, "--cull", *argv])
            wall[run] = time.perf_counter() - t0
            c = launches[f"train CLI, {run}"] = _read_counts()
            if c["raster"] == 0 or c["smpl_verts"] == 0 or c["smpl_verts_backward"] == 0:
                raise AssertionError(f"train CLI ({run}) did not launch K4, K2 and K2's backward: {c}")
        with open(os.path.join(exp, "log.pkl"), "rb") as f:
            history = pickle.load(f)
        ckpts = [os.path.join(exp, f"epoch_{e:06d}.pt") for e in range(3)]
        if not all(os.path.exists(p) for p in ckpts) or len(history["train_losses"]) != 3:
            raise AssertionError(f"train CLI wrote {sorted(os.listdir(exp))}, {len(history['train_losses'])} epochs")
        if not all(math.isfinite(x) for k in ("train_losses", "val_losses", "val_PVE-SC") for x in history[k]):
            raise AssertionError(f"train CLI recorded a non-finite loss or metric: {history}")
        steps = {"2 epochs": 2 * 3, "resume, epoch 3": 3}
        print(f"train CLI B={TRAIN_B} {IMG}², {TRAIN_POSES} train / {VAL_POSES} val poses: train losses "
              f"{', '.join(f'{x:.2f}' for x in history['train_losses'])}; val PVE-SC "
              f"{', '.join(f'{x:.4f}' for x in history['val_PVE-SC'])}; "
              + "; ".join(f"{run} {s:.1f} s wall ({1e3 * s / steps[run]:.0f} ms a batch with set-up)"
                          for run, s in wall.items()))

        _write_eval_sets(root)
        for protocol, n in (("3dpw", 10), ("ssp3d", N)):
            out_dir = os.path.join(root, f"eval_{protocol}")
            _zero_counts()
            final = run_evaluate.main(["-D", protocol, "-C", ckpts[-1], "-B", str(B), "-N", str(n), "-S", out_dir])
            c = launches[f"evaluate CLI, {protocol}"] = _read_counts()
            if c["smpl_verts"] == 0 or (protocol == "ssp3d" and c["coverage"] == 0):
                raise AssertionError(f"evaluate CLI ({protocol}) launched {c}")
            frames = {f: np.load(os.path.join(out_dir, f)) for f in os.listdir(out_dir)
                      if f.endswith("_per_frame.npy") and f != "fname_per_frame.npy"}
            bad = [f for f, a in frames.items() if a.shape[0] != EVAL_FRAMES or not np.isfinite(a).all()]
            if bad or not frames or not all(math.isfinite(v) for v in final.values()):
                raise AssertionError(f"evaluate CLI ({protocol}): bad per-frame files {bad} or metrics {final}")
            print(f"evaluate CLI {protocol} B={B} N={n}: {len(frames)} per-frame metric files of {EVAL_FRAMES} "
                  f"frames, finite")
    finally:
        for k, v in saved.items():
            setattr(paths, k, v)
    return launches, ckpts[-1]


# ---------------------------------------------------------------- phase 16

MESH_STEPS = 3  # phase 16a: data-parallel train steps at world size 1


def _mesh_train_inputs(mesh):
    """Phase 16's training inputs at TRAIN_B, made on the card from a seed
    (poses, textures, backgrounds); on a mesh, this rank's block."""
    import torch

    g = torch.Generator("cuda").manual_seed(91)
    inputs = [0.3 * torch.randn((TRAIN_B, 72), generator=g, device="cuda"),
              torch.rand((TRAIN_B, 1200, 800, 3), generator=g, device="cuda"),
              torch.rand((TRAIN_B, IMG, IMG, 3), generator=g, device="cuda")]
    if mesh is not None:
        from humaniflow_torch.parallel import shard_batch

        inputs = shard_batch(inputs, mesh)
    return inputs


def _mesh_train(cfg, smpl, mesh, steps):
    """`steps` synthetic batches and train steps at TRAIN_B from the seed-0
    model, in one process (mesh None) or as a rank of a data mesh; returns
    (each step's loss terms, the first step's gradients on the host, the
    launches, (the step, the last batch, the generator))."""
    import torch

    from humaniflow_torch.data.augmentation import Draws
    from humaniflow_torch.models import HumaniflowModel
    from humaniflow_torch.parallel import axis_rank, axis_size, replicate
    from humaniflow_torch.pipelines import make_optimizer, make_synth_data_fn, make_train_step

    model = HumaniflowModel(cfg.MODEL, generator=torch.Generator().manual_seed(0))
    shard = None
    if mesh is not None:
        replicate(model, mesh)
        shard = (axis_rank(mesh, "data"), axis_size(mesh, "data"))
    step = make_train_step(model, smpl, cfg.LOSS, make_optimizer(model, cfg), img_wh=IMG, mesh=mesh)
    synth = make_synth_data_fn(cfg, smpl, _training_renderer())
    inputs = _mesh_train_inputs(mesh)
    gen = torch.Generator("cuda").manual_seed(92)
    draws = Draws(gen, shard=shard)
    losses, grads = [], None
    _zero_counts()
    for _ in range(steps):
        batch = synth(draws, *inputs)
        batch.pop("rgb_in"), batch.pop("binning_overflow")
        losses.append({k: float(v) for k, v in step(batch, generator=gen).items()})
        if grads is None:
            grads = {k: p.grad.detach().cpu() for k, p in model.named_parameters()}
    return losses, grads, _read_counts(), (step, batch, gen)


def _mesh_small_step(cfg, mesh):
    """One train step at phase 11c's small shape (B=2, 64², 2 joint samples,
    its weights, batch and noise), in one process or as a rank of a data
    mesh (its block of the batch and of the noise); returns (its loss terms,
    its gradients on the host)."""
    import dataclasses

    import torch

    from humaniflow_torch.models import HumaniflowModel, synthetic_smpl
    from humaniflow_torch.parallel import replicate, shard_batch
    from humaniflow_torch.pipelines import make_optimizer, make_train_step

    b, img, nj = 2, 64, 2
    small = dataclasses.replace(cfg, LOSS=dataclasses.replace(cfg.LOSS, NUM_J2D_SAMPLES=nj))
    model = HumaniflowModel(small.MODEL, generator=torch.Generator().manual_seed(51))
    g = torch.Generator().manual_seed(52)
    noise = (torch.randn((b, nj, 10), generator=g).cuda(),
             [torch.randn((b, nj, len(p), 3), generator=g).cuda() for p in model.levels])
    batch = _train_batch(b, img, 53, "cuda")
    if mesh is not None:
        replicate(model, mesh)
        batch, noise = shard_batch((batch, noise), mesh)
    step = make_train_step(model, synthetic_smpl(num_verts=V), small.LOSS, make_optimizer(model, small), img_wh=img,
                           mesh=mesh)
    metrics = step(batch, noise=noise)
    return [{k: float(v) for k, v in metrics.items()}], {k: p.grad.detach().cpu() for k, p in model.named_parameters()}


def _mesh_ssp3d(model, smpls, cfg, mesh):
    """One SSP-3D batch (B=32, N=100, 256²) through evaluate_humaniflow,
    in one process or on a mesh; returns (final metrics, launches)."""
    import torch

    from humaniflow_torch.pipelines import EVAL_METRICS_SSP3D, evaluate_humaniflow
    from humaniflow_torch.utils.profiling import SyntheticEvalDataset

    _zero_counts()
    final = evaluate_humaniflow(model, *smpls, cfg, SyntheticEvalDataset(B, IMG), EVAL_METRICS_SSP3D, batch_size=B,
                                num_pred_samples=N, renderer=_counting_renderer(img_wh=IMG, render_rgb=False),
                                generator=torch.Generator("cuda").manual_seed(11), mesh=mesh)
    return final, _read_counts()


def _rank_setup(cfg):
    """A rank's default model (seed 0, as phase 3's) and the three SMPL models."""
    import torch

    from humaniflow_torch.models import HumaniflowModel, synthetic_smpl

    model = HumaniflowModel(cfg.MODEL, generator=torch.Generator().manual_seed(0))
    return model, tuple(synthetic_smpl(num_verts=V, seed=s) for s in (0, 1, 2))


def _pred_digest(pred):
    """The outputs of a predict run that phase 16 holds (the samples' vertices
    every tenth sample), on the host."""
    out = {k: pred[k].cpu() for k in ("verts_point_est", "tpose_verts", "pose_rotmats_samples",
                                      "vertex_uncertainty_l2", "vertex_uncertainty_directional")}
    out["verts_samples"] = pred["verts_samples"][:, ::10].cpu()
    return out


def _gather_launches(launches):
    """Every rank's launches by path, on every rank."""
    import torch.distributed as dist

    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, launches)
    return every


def _mesh_rank_nccl(rank, device, cfg):
    """Phase 16a, the one rank of an NCCL process group: predict on a 1-D and
    a 1×1 mesh, the sharded inference program, one SSP-3D batch and
    MESH_STEPS train steps, each at full width; then the mesh path's overhead
    against the one-process path, in turns."""
    import torch

    from humaniflow_torch import parallel
    from humaniflow_torch.pipelines import predict_humaniflow
    from humaniflow_torch.utils.profiling import wall_ms

    t0 = time.perf_counter()
    model, smpls = _rank_setup(cfg)
    smpl = smpls[0]
    mesh, mesh11 = parallel.make_mesh(1), parallel.make_mesh_2d(1, 1)
    parallel.replicate(model, mesh)
    images, joints2d, conf = _inputs(B)
    out, launches = {"predict": {}}, {}
    for name, m in (("1-D", mesh), ("1x1", mesh11)):
        _zero_counts()
        pred = predict_humaniflow(model, smpl, cfg, images, joints2d, conf, num_samples=N,
                                  generator=torch.Generator("cuda").manual_seed(7), mesh=m)
        launches[f"predict, {name} mesh"] = _read_counts()
        out["predict"][name] = _pred_digest(pred)
    infer = parallel.make_sharded_inference_fn(model, smpl, mesh11, num_samples=N)
    _zero_counts()
    out["infer"] = [x.cpu() for x in infer(pred["proxy_rep"], generator=torch.Generator("cuda").manual_seed(7))]
    launches["sharded inference, 1x1 mesh"] = _read_counts()
    out["ssp3d"], launches["SSP-3D batch, 1-D mesh"] = _mesh_ssp3d(model, smpls, cfg, mesh)
    out["train"], out["train_grads"], launches[f"train, {MESH_STEPS} steps, 1-D mesh"], (mesh_step, batch, gen) = \
        _mesh_train(cfg, smpl, mesh, MESH_STEPS)
    out["small_step"] = _mesh_small_step(cfg, mesh)
    out["wall_s"] = time.perf_counter() - t0

    plain_step = _mesh_train(cfg, smpl, None, 1)[3][0]
    turns = {"one process": [], "1-D mesh": []}
    for name in ("one process", "1-D mesh", "1-D mesh", "one process"):
        m = mesh if name == "1-D mesh" else None
        step = mesh_step if m is not None else plain_step
        turns[name].append((
            wall_ms(lambda: predict_humaniflow(model, smpl, cfg, images, joints2d, conf, num_samples=N,
                                               generator=gen.manual_seed(8), mesh=m), 3),
            wall_ms(lambda: step(batch, generator=gen), 3),
        ))
    out["turns"], out["launches"] = turns, _gather_launches(launches)
    return out


def _mesh_rank_gloo(rank, device, cfg):
    """Phase 16b, a rank of 2 gloo ranks on the one card: the sample split of
    distribution inference on a 1×2 mesh on the default route (K5, and K1 at
    (32, 50) on each rank), a
    data-parallel train step at TRAIN_B (36 a rank) and one SSP-3D batch (16
    a rank), each at full width."""
    import torch

    from humaniflow_torch import parallel
    from humaniflow_torch.pipelines.predict import build_proxy_representation

    t0 = time.perf_counter()
    model, smpls = _rank_setup(cfg)
    smpl = smpls[0]
    mesh, mesh12 = parallel.make_mesh(2), parallel.make_mesh_2d(1, 2)
    parallel.replicate(model, mesh)
    images, joints2d, conf = (torch.as_tensor(a, device="cuda") for a in _inputs(B))
    proxy = build_proxy_representation(images, joints2d, conf, cfg)
    out, launches = {}, {}
    infer = parallel.make_sharded_inference_fn(model, smpl, mesh12, num_samples=N)
    _set_fused(True)  # the sample split on the default route (K5); the rest of the rank eager
    _zero_counts()
    out["infer"] = [x.cpu() for x in infer(proxy, generator=torch.Generator("cuda").manual_seed(7))]
    launches["sample split, 1x2 mesh"] = _read_counts()
    _set_fused(False)
    out["train"], out["train_grads"], launches["train step, 2 ranks"], _ = _mesh_train(cfg, smpl, mesh, 1)
    out["small_step"] = _mesh_small_step(cfg, mesh)
    out["ssp3d"], launches["SSP-3D batch, 2 ranks"] = _mesh_ssp3d(model, smpls, cfg, mesh)
    out["wall_s"] = time.perf_counter() - t0
    out["launches"] = _gather_launches(launches)
    return out


def _hold_train(name, got, got_grads, want, want_grads, encoder_grads=True):
    """A data-parallel run's train steps against the one-process ones: every
    step's loss terms within LOSS_RTOL, the first step's gradients within
    GRAD_RTOL of each tensor's largest, and every step finite and taken.
    encoder_grads=False holds the gradients of the heads and flows only and
    prints the encoder's: at B=72 from these random weights, the encoder's
    BatchNorm backward is ill-conditioned in float32 (a channel whose
    upstream gradient lies near the span of 1 and the normalised input
    leaves a residual that any reordering of a sum moves by ~1e-2; on the
    CPU, float32 BatchNorm itself misses float64 by 1e-2 there), so the
    encoder is held at the small step instead (_mesh_small_step)."""
    import math

    terms = ("pose_nll", "shape_nll", "joints2D", "glob_rotmats", "total")
    worst_loss = max(abs(a[k] - b[k]) / abs(b[k]) for a, b in zip(got, want) for k in terms)
    errs = {k: float((got_grads[k] - g).abs().max() / g.abs().max().clamp(min=1e-30)) for k, g in want_grads.items()}
    held = {k: e for k, e in errs.items() if encoder_grads or not k.startswith("encoder.")}
    worst_name = max(held, key=held.get)
    line = (f"{name}: loss terms of {len(got)} step(s) within {worst_loss:.3e} relative, the first step's "
            f"{'' if encoder_grads else 'head and flow '}gradients within {held[worst_name]:.3e} of each tensor's "
            f"largest ({worst_name})")
    if not encoder_grads:
        enc = max((k for k in errs if k not in held), key=errs.get)
        line += f"; the encoder's within {errs[enc]:.3e} ({enc}), not held here"
    print(line)
    if not (worst_loss <= LOSS_RTOL and held[worst_name] <= GRAD_RTOL):
        raise AssertionError(f"{name} disagrees with the one-process step")
    if not all(math.isfinite(m["total"]) and m["nan_skipped"] == 0.0 for m in got):
        raise AssertionError(f"{name}: a step gave a non-finite loss or was skipped")


def _hold_metrics(name, got, want):
    worst = {m: abs(got[m] - w) / (1.0 if "IOU" in m else abs(w)) for m, w in want.items()}
    print(f"{name}: metrics within {max(v for m, v in worst.items() if 'IOU' not in m):.3e} relative, IOU within "
          f"{max(v for m, v in worst.items() if 'IOU' in m):.3e}")
    bad = [m for m, v in worst.items() if v > (IOU_ATOL if "IOU" in m else METRIC_RTOL)]
    if bad or set(got) != set(want):
        raise AssertionError(f"{name} disagrees with the one-process batch: {bad}")


def _hold_launches(name, every, needed):
    for rank, launches in enumerate(every):
        total = {k: sum(c[k] for c in launches.values()) for k in needed}
        print(f"{name}, rank {rank}: " + "; ".join(f"{p} {c}" for p, c in launches.items()))
        if not all(total.values()):
            raise AssertionError(f"{name}: rank {rank} did not launch {[k for k, v in total.items() if not v]}")


def multi_device(model, smpls, cfg, pred, verts_pe, vertex_var, infer_f, card, cli_files):
    """Phase 16: the parallel layer on the card.  (a) NCCL at world size 1
    (predict on a 1-D and a 1×1 mesh, the sharded inference program, one
    SSP-3D batch, MESH_STEPS train steps) held to the one-process paths;
    (b) 2 gloo ranks on the one card (the 1×2 sample split on the default
    route held to phase 9's (vertices, variance) `infer_f`, K5 once a level
    on each rank; a train step and an SSP-3D batch held to one process); then the three
    CLIs with --num_devices 1 on phase 15's files.  Returns the ranks'
    launches by path."""
    import torch

    from humaniflow_torch import parallel

    ref_ssp3d, _ = _mesh_ssp3d(model, smpls, cfg, None)
    ref_train, ref_grads, _, _ = _mesh_train(cfg, smpls[0], None, MESH_STEPS)
    ref_small = _mesh_small_step(cfg, None)
    want_pred = _pred_digest(pred)
    launches = {}

    t0 = time.perf_counter()
    a = parallel.spawn(_mesh_rank_nccl, 1, "cuda", cfg)
    wall_a = time.perf_counter() - t0
    for name, got in a["predict"].items():
        diffs = {k: float((got[k] - w).abs().max()) for k, w in want_pred.items()}
        print(f"16a predict on the {name} mesh (NCCL, 1 rank) vs phase 3, max abs diff: "
              + ", ".join(f"{k} {d:.3e}" for k, d in diffs.items()))
        if not all(d <= SLICE_ATOL for d in diffs.values()):
            raise AssertionError(f"predict on the {name} mesh disagrees with phase 3")
    for tag, (verts, var) in (("16a sharded inference, 1x1 mesh (NCCL)", a["infer"]),):
        print(f"{tag} vs phase 4: vertices within {float((verts - verts_pe.cpu()).abs().max()):.3e} m, variance "
              f"within {float((var - vertex_var.cpu()).abs().max()):.3e} m^2")
        torch.testing.assert_close(verts, verts_pe.cpu(), rtol=0, atol=VERTS_ATOL)
        torch.testing.assert_close(var, vertex_var.cpu(), rtol=VAR_RTOL, atol=VAR_ATOL)
    _hold_metrics("16a SSP-3D batch, 1-D mesh (NCCL)", a["ssp3d"], ref_ssp3d)
    _hold_train(f"16a {MESH_STEPS} train steps at B={TRAIN_B}, 1-D mesh (NCCL)", a["train"], a["train_grads"],
                ref_train, ref_grads, encoder_grads=False)
    _hold_train("16a train step at B=2, 64², 1-D mesh (NCCL)", *a["small_step"], *ref_small)
    _hold_launches("16a launches", a["launches"], ("smpl_moments", "smpl_verts", "coverage", "raster"))
    (p1, s1), (p2, s2) = (tuple(sum(x[i] for x in a["turns"][k]) / 2 for i in range(2))
                          for k in ("one process", "1-D mesh"))
    print(f"16a one process against the 1-D mesh at world size 1, in turns in the rank: predict B={B} N={N} "
          f"{B / p1 * 1e3:.1f} against {B / p2 * 1e3:.1f} img/s ({p1:.2f} against {p2:.2f} ms), train step "
          f"B={TRAIN_B} {s1:.2f} against {s2:.2f} ms (each turn's predict and step ms: {a['turns']})")

    t0 = time.perf_counter()
    b = parallel.spawn(_mesh_rank_gloo, 2, "cuda", cfg, backend="gloo")
    wall_b = time.perf_counter() - t0
    verts, var = b["infer"]
    verts_f, var_f = (x.cpu() for x in infer_f)
    print(f"16b sample split, 1x2 mesh (gloo, 2 ranks, K5 and K1 at ({B}, {N // 2}) each) vs phase 9: vertices "
          f"within {float((verts - verts_f).abs().max()):.3e} m, variance within "
          f"{float((var - var_f).abs().max()):.3e} m^2")
    torch.testing.assert_close(verts, verts_f, rtol=0, atol=VERTS_ATOL)
    torch.testing.assert_close(var, var_f, rtol=VAR_RTOL, atol=VAR_ATOL)
    for rank, per_path in enumerate(b["launches"]):
        if per_path["sample split, 1x2 mesh"]["flow_level"] != len(model.levels):
            raise AssertionError(f"16b sample split: rank {rank} launched K5 "
                                 f"{per_path['sample split, 1x2 mesh']['flow_level']} times, not once a level")
    _hold_train(f"16b train step at B={TRAIN_B} on 2 ranks ({TRAIN_B // 2} each, gloo)", b["train"],
                b["train_grads"], ref_train[:1], ref_grads, encoder_grads=False)
    _hold_train("16b train step at B=2, 64² on 2 ranks (1 each, gloo)", *b["small_step"], *ref_small)
    _hold_metrics(f"16b SSP-3D batch on 2 ranks ({B // 2} each, gloo)", b["ssp3d"], ref_ssp3d)
    _hold_launches("16b launches", b["launches"], ("smpl_moments", "smpl_verts", "coverage", "raster"))
    for tag, every in (("16a", a["launches"]), ("16b", b["launches"])):
        for rank, per_path in enumerate(every):
            launches.update({f"{tag} rank {rank}: {p}": c for p, c in per_path.items()})
    print(f"16a NCCL, 1 rank: {wall_a:.1f} s wall ({a['wall_s']:.1f} s in the rank before its timing turns); 16b gloo, "
          f"2 ranks on one card: {wall_b:.1f} s wall ({b['wall_s']:.1f} s in rank 0); {card}")
    mesh_clis(cli_files)
    return launches


def mesh_clis(cli_files):
    """Phase 16c: the predict (--num_devices 1 --sample_devices 1), evaluate
    (3DPW, --num_devices 1) and train (-D 1) CLIs, each spawning its rank,
    on phase 15's files laid out as configs/paths.py finds them through
    HUMANIFLOW_MODEL_FILES and HUMANIFLOW_DATA; the evaluation's per-frame
    metrics held to phase 15c's one-process files."""
    import math
    import pickle

    import cv2
    import numpy as np

    from humaniflow_torch.cli import run_evaluate, run_predict, run_train
    from humaniflow_torch.configs import paths

    root, ckpt = cli_files
    layout = {
        **{os.path.join("model_files", "smpl", f"SMPL_{g}.npz"): os.path.join(root, f"SMPL_{g}.npz")
           for g in ("NEUTRAL", "MALE", "FEMALE")},
        **{os.path.join("model_files", os.path.basename(f)): f
           for f in (paths.J_REGRESSOR_EXTRA, paths.COCOPLUS_REGRESSOR, paths.H36M_REGRESSOR, paths.DENSEPOSE_UV)},
        os.path.join("data", "3dpw", "test"): os.path.join(root, "3dpw"),
        os.path.join("data", "ssp_3d"): os.path.join(root, "ssp3d"),
    }
    for split in ("train", "val"):
        layout[os.path.join("data", "training", f"smpl_{split}_poses.npz")] = os.path.join(root, split, "poses.npz")
        layout[os.path.join("data", "training", f"smpl_{split}_textures.npz")] = os.path.join(root, split,
                                                                                             "textures.npz")
        layout[os.path.join("data", "training", "lsun_backgrounds", split)] = os.path.join(root, split, "backgrounds")
    for link, target in layout.items():
        link = os.path.join(root, "layout", link)
        os.makedirs(os.path.dirname(link), exist_ok=True)
        os.symlink(target, link)
    images = os.path.join(root, "images")
    os.makedirs(images)
    for i, img in enumerate(_uncropped_images(4, seed=101)):
        cv2.imwrite(os.path.join(images, f"u{i}.png"), (img[..., ::-1] * 255).astype(np.uint8))
    saved = {k: os.environ.get(k) for k in ("HUMANIFLOW_MODEL_FILES", "HUMANIFLOW_DATA")}
    os.environ["HUMANIFLOW_MODEL_FILES"] = os.path.join(root, "layout", "model_files")
    os.environ["HUMANIFLOW_DATA"] = os.path.join(root, "layout", "data")
    wall = {}
    try:
        t0 = time.perf_counter()
        out = os.path.join(root, "predict_mesh")
        run_predict.main(["-I", images, "-S", out, "-C", ckpt, "-N", str(N), "--num_devices", "1",
                          "--sample_devices", "1"])
        wall["predict"] = time.perf_counter() - t0
        preds = [np.load(os.path.join(out, f)) for f in sorted(os.listdir(out))]
        if len(preds) != 4 or not all(np.isfinite(d[k]).all() for d in preds for k in d.files):
            raise AssertionError(f"predict CLI --num_devices 1 wrote {sorted(os.listdir(out))}, or non-finite values")

        t0 = time.perf_counter()
        out = os.path.join(root, "eval_3dpw_mesh")
        run_evaluate.main(["-D", "3dpw", "-C", ckpt, "-B", str(B), "-N", "10", "-S", out, "--num_devices", "1"])
        wall["evaluate"] = time.perf_counter() - t0
        worst = 0.0
        for f in os.listdir(os.path.join(root, "eval_3dpw")):
            want, got = np.load(os.path.join(root, "eval_3dpw", f)), np.load(os.path.join(out, f))
            if want.dtype.kind in "US":
                if not np.array_equal(got, want):
                    raise AssertionError(f"evaluate CLI --num_devices 1: {f} differs")
                continue
            worst = max(worst, float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)))
        if not worst <= METRIC_RTOL:
            raise AssertionError(f"evaluate CLI --num_devices 1: per-frame metrics off phase 15c's by {worst}")

        t0 = time.perf_counter()
        exp = os.path.join(root, "experiment_mesh")
        run_train.main(["-E", exp, "--cull", "-O", "TRAIN.NUM_EPOCHS", "1", "-D", "1"])
        wall["train"] = time.perf_counter() - t0
        with open(os.path.join(exp, "log.pkl"), "rb") as f:
            history = pickle.load(f)
        if not os.path.exists(os.path.join(exp, "epoch_000000.pt")) or not all(
                math.isfinite(history[k][-1]) for k in ("train_losses", "val_losses", "val_PVE-SC")):
            raise AssertionError(f"train CLI -D 1 wrote {sorted(os.listdir(exp))} or a non-finite loss")
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    print(f"16c CLIs with --num_devices 1 (one NCCL rank each): predict N={N} 4 images {wall['predict']:.1f} s, "
          f"evaluate 3DPW B={B} N=10 {wall['evaluate']:.1f} s (per-frame metrics within {worst:.3e} of phase 15c's), "
          f"train 1 epoch at B={TRAIN_B} {wall['train']:.1f} s (train loss {history['train_losses'][-1]:.2f}); "
          "wall times with each rank's start")


# ---------------------------------------------------------------- phase 17


def _pw3d_helpers():
    """tests/_torch_pw3d.py: the fabricated release and the checks shared with
    the CPU tests (numpy and OpenCV only)."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    try:
        return importlib.import_module("_torch_pw3d")
    finally:
        sys.path.pop(0)


def _logged_rotations(release, names, device):
    """What pw3d_preprocess logs for each named frame with so3_exp and so3_log
    on `device`, computed apart from it, one person at a time as it batches
    (tests/_torch_pw3d.py::logged_rotations)."""
    import torch

    from humaniflow_torch.ops import so3_exp, so3_log

    on = lambda fn: lambda a: fn(torch.from_numpy(a).to(device)).cpu().numpy()  # noqa: E731
    return _pw3d_helpers().logged_rotations(release, names, on(so3_exp), on(so3_log))


def _hold_k2_rows_to_one_row_launches(smpl, rows):
    """K2's forward at `rows` rows against `rows` one-row launches of the
    same inputs, bit for bit (the rows are independent); launches not counted."""
    import torch

    from humaniflow_torch.models import cuda_lbs

    args = _kernel_args(smpl, (rows,), V, seed=rows + 1)
    got = cuda_lbs.smpl_verts(*args)
    for i in range(rows):
        one = cuda_lbs.smpl_verts(*(a[i : i + 1].clone() for a in args[:3]), *args[3:])
        if not torch.equal(got[i : i + 1], one):
            raise AssertionError(f"K2 at {rows} rows differs from its one-row launch at row {i}")


def _reference_hrnet_pth(hrnet, path):
    """Save `hrnet`'s weights under the reference's names (the inverse of
    utils/load_reference.py's map), as pose_hrnet_w48_384x288.pth lays them out."""
    import torch

    from humaniflow_torch.utils.load_reference import _hrnet_reference_name

    sd = {}
    for key, v in hrnet.state_dict().items():
        module, leaf = key.rsplit(".", 1)
        sd[f"{_hrnet_reference_name(module)}.{leaf}"] = v.detach().cpu()
    torch.save(sd, path)


def _hold_keypoints_to_cpu(frames_dir, names, card_kps, pth):
    """The card's keypoints of two frames against the CLI on the CPU, by
    phase 10's rule on the heatmaps without the final-layer bias (a constant
    per joint, which phase 10's nets leave out): within HEATMAP_RTOL of their
    largest |value|, here plus the rounding of adding the bias on each side
    (an ulp of the largest |heatmap|).  Confidences (the heatmap maxima)
    within that tolerance; keypoints equal wherever the heatmap's top-2 gap
    exceeds it (the CPU heatmaps decide)."""
    import shutil

    import cv2
    import numpy as np
    import torch

    from humaniflow_torch.cli import generate_hrnet_keypoints
    from humaniflow_torch.models import PoseHighResolutionNet
    from humaniflow_torch.utils.load_reference import load_hrnet_checkpoint

    ph = importlib.import_module("humaniflow_torch.pipelines.predict_hrnet")
    two = os.path.join(os.path.dirname(frames_dir), "two_frames")
    os.makedirs(two)
    for name in names:
        shutil.copy(os.path.join(frames_dir, name), two)
    cpu_kps = generate_hrnet_keypoints.main(["--frames_dir", two, "--out_path", os.path.join(two, "kps.npy"),
                                             "--hrnet_checkpoint", pth, "--device", "cpu"])
    w_in, h_in = ph.HRNET_INPUT_WH
    imgs = np.stack([cv2.resize(cv2.cvtColor(cv2.imread(os.path.join(two, n)), cv2.COLOR_BGR2RGB), (w_in, h_in))
                     for n in names]) / 255.0
    hrnet = load_hrnet_checkpoint(pth, PoseHighResolutionNet(device="cpu"))
    with torch.inference_mode():
        hm = hrnet((torch.from_numpy(imgs).float() - torch.tensor(ph.IMAGENET_MEAN)) / torch.tensor(ph.IMAGENET_STD))
    bias_free = hm - hrnet.final_layer.bias
    tol = HEATMAP_RTOL * float(bias_free.abs().max()) + float(torch.finfo(torch.float32).eps * hm.abs().max())
    top2 = bias_free.reshape(len(names), -1, hm.shape[-1]).topk(2, dim=1).values
    decisive = ((top2[:, 0] - top2[:, 1]) > tol).numpy()
    conf_err = float(np.abs(card_kps[..., 2] - cpu_kps[..., 2]).max())
    differ = (card_kps[..., :2] != cpu_kps[..., :2]).any(-1)
    print(f"17b keypoints card vs CPU (2 frames): confidences within {conf_err:.3e} (tolerance {tol:.3e}); keypoints "
          f"differ {int(differ.sum())} of {differ.size}, {int((differ & decisive).sum())} of them decisive "
          f"({int(decisive.sum())} decisive)")
    if not conf_err <= tol or bool((differ & decisive).any()):
        raise AssertionError("the card's HRNet keypoints disagree with the CPU's")


def prepare_pw3d(smpl, cli_files):
    """Phase 17: the data-preparation path on the card.  (a) pw3d_preprocess
    on a fabricated 3DPW release (1080×1920 JPEG frames, 494 person-frames),
    held to the same CLI on the CPU on one sequence, K2 launched once a
    person; (b) generate_hrnet_keypoints on its crops (HRNet-W48 at 384×288,
    B=16, float32, damped seeded weights from a reference-layout .pth), held
    to the CPU on 2 frames; (c) the evaluate CLI (3DPW, N=10) on the prepared
    directory with phase 15's checkpoint.  Returns the counted launches by path."""
    import math
    import shutil

    import numpy as np

    from humaniflow_torch.cli import generate_hrnet_keypoints, pw3d_preprocess, run_evaluate
    from humaniflow_torch.configs import paths

    helpers = _pw3d_helpers()
    cli_root, ckpt = cli_files
    root = os.path.join(cli_root, "pw3d17")
    release, prepared, cpu_release, cpu_out = (os.path.join(root, d) for d in ("release", "prepared", "cpu_release",
                                                                               "cpu_out"))
    launches = {}
    saved = dict(vars(paths))
    t_phase = time.perf_counter()
    try:
        for gender in ("NEUTRAL", "MALE", "FEMALE"):
            setattr(paths, f"SMPL_{gender}", os.path.join(cli_root, f"SMPL_{gender}.npz"))
        t0 = time.perf_counter()
        helpers.write_pw3d_release(release, PW3D_SEQUENCES, frame_wh=PW3D_FRAME_WH, focal=PW3D_FOCAL, seed=17)
        fabricate_s = time.perf_counter() - t0

        # ---- (a) pw3d_preprocess on the card
        _zero_counts()
        t0 = time.perf_counter()
        res = pw3d_preprocess.main(["--pw3d_dir", release, "--out_dir", prepared])
        wall = time.perf_counter() - t0
        c = launches["pw3d_preprocess"] = _read_counts()
        rows = _pw3d_rows()
        if res["smpl_rows"] != list(rows) or c["smpl_verts"] != len(rows):
            raise AssertionError(f"pw3d_preprocess: SMPL rows {res['smpl_rows']} (want {list(rows)}), K2 "
                                 f"launched {c['smpl_verts']} times (one a person: {len(rows)})")
        print(f"17a pw3d_preprocess {res['frames']} frames of {PW3D_FRAME_WH[0]}x{PW3D_FRAME_WH[1]}: "
              f"{res['frames'] / wall:.1f} frames/s ({wall:.2f} s: device stage (upload, so3_exp, so3_log, K2 at "
              f"{res['smpl_rows']} rows, download) {1e3 * res['device_s']:.1f} ms, host decode/box/crop/write "
              f"{1e3 * res['host_s']:.1f} ms); the release fabricated in {fabricate_s:.1f} s")
        _hold_k2_rows_to_one_row_launches(smpl, rows[-1])

        # the same CLI on the CPU, on one sequence
        os.makedirs(os.path.join(cpu_release, "sequenceFiles", "test"))
        os.makedirs(os.path.join(cpu_release, "imageFiles"))
        shutil.copy(os.path.join(release, "sequenceFiles", "test", f"{PW3D_CPU_SEQUENCE}.pkl"),
                    os.path.join(cpu_release, "sequenceFiles", "test"))
        os.symlink(os.path.join(release, "imageFiles", PW3D_CPU_SEQUENCE),
                   os.path.join(cpu_release, "imageFiles", PW3D_CPU_SEQUENCE))
        cpu_res = pw3d_preprocess.main(["--pw3d_dir", cpu_release, "--out_dir", cpu_out, "--device", "cpu"])
        card, cpu = (dict(np.load(os.path.join(d, "3dpw_test.npz"))) for d in (prepared, cpu_out))
        sel = np.array([str(n).startswith(f"{PW3D_CPU_SEQUENCE}_p") for n in card["imgname"]])
        card_sel = {k: v[sel] for k, v in card.items()}
        helpers.hold_labels(cpu, card_sel)
        logged = {dev: _logged_rotations(release, cpu["imgname"], dev) for dev in ("cpu", "cuda")}
        rot, r_apart, log_loss = helpers.hold_orientations(cpu["pose"], card_sel["pose"], logged["cpu"],
                                                           logged["cuda"], PW3D_ROT_ATOL, PW3D_LOG_ATOL)
        apart, share = helpers.hold_crops(cpu_out, prepared, cpu["imgname"], cpu_res["corners"], res["corners"][sel],
                                          cpu["joints2D_coco"], card_sel["joints2D_coco"], PW3D_CORNER_ATOL,
                                          PW3D_J2D_ATOL, PW3D_CLEAR_SHARE)
        print(f"17a card vs CPU on {PW3D_CPU_SEQUENCE} ({int(sel.sum())} frames): names, genders, shapes, body poses "
              f"equal; each side's orientations the so3_log of its logged rotations bit for bit, the rotations "
              f"within {r_apart:.3e}, so3_log's loss {log_loss:.3e}, orientations within {rot:.3e}; box corners "
              f"within {apart:.3e} px; crops and integer boxes equal, 2D joints within {PW3D_J2D_ATOL} px (scaled by "
              f"the boxes' sizes) on {100 * share:.1f}% of the frames (the rest lie within their corners' difference "
              f"of a rounding boundary)")

        # ---- (b) HRNet keypoints of the crops, HRNet-W48 at 384×288, float32
        pth = os.path.join(root, "pose_hrnet_w48_384x288.pth")
        _reference_hrnet_pth(_damped_hrnet(device="cpu"), pth)
        frames_dir = os.path.join(prepared, "cropped_frames")
        t0 = time.perf_counter()
        kps = generate_hrnet_keypoints.main(["--frames_dir", frames_dir, "--out_path",
                                             os.path.join(prepared, "hrnet_results_centred.npy"),
                                             "--hrnet_checkpoint", pth, "--batch_size", "16"])
        hr_wall = time.perf_counter() - t0
        if kps.shape != (res["frames"], 17, 3) or not np.isfinite(kps).all():
            raise AssertionError(f"generate_hrnet_keypoints wrote {kps.shape}, finite {np.isfinite(kps).all()}")
        print(f"17b generate_hrnet_keypoints {res['frames']} crops of 512², B=16: {res['frames'] / hr_wall:.1f} "
              f"frames/s ({hr_wall:.2f} s with the weights' load)")
        names = sorted(os.listdir(frames_dir))[:2]
        _hold_keypoints_to_cpu(frames_dir, names, kps[:2], pth)

        # ---- (c) the evaluate CLI on the prepared directory
        paths.PW3D_PATH = prepared
        out_dir = os.path.join(root, "eval_3dpw")
        _zero_counts()
        t0 = time.perf_counter()
        final = run_evaluate.main(["-D", "3dpw", "-C", ckpt, "-B", str(B), "-N", "10", "-S", out_dir])
        ev_wall = time.perf_counter() - t0
        c = launches["evaluate CLI, prepared 3DPW"] = _read_counts()
        frames = {f: np.load(os.path.join(out_dir, f)) for f in os.listdir(out_dir)
                  if f.endswith("_per_frame.npy") and f != "fname_per_frame.npy"}
        bad = [f for f, a in frames.items() if a.shape[0] != res["frames"] or not np.isfinite(a).all()]
        if c["smpl_verts"] == 0 or bad or not frames or not all(math.isfinite(v) for v in final.values()):
            raise AssertionError(f"evaluate CLI on the prepared 3DPW: K2 {c['smpl_verts']}, bad files {bad}, {final}")
        print(f"17c evaluate CLI 3dpw B={B} N=10 on the {res['frames']} prepared frames: {len(frames)} per-frame "
              f"metric files, finite; {ev_wall:.1f} s wall; PVE-SC {final.get('PVE-SC', float('nan')):.4f}")
    finally:
        for k, v in saved.items():
            setattr(paths, k, v)
    print(f"phase 17 (data preparation → evaluation): {time.perf_counter() - t_phase:.1f} s wall")
    return launches


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
    from humaniflow_torch.utils.profiling import cuda_ms, device_profile, flow_route, wall_ms

    _set_fused(False)  # phases 1-7: the eager flow

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
    k3 = split["k3"]
    records["coverage"].update(
        ssp3d_batch_ms=sum(g["launches"] * g["ms"] for g in k3.values()),
        ssp3d_batch_bound_ms=sum(g["launches"] * g["bound_ms"] for g in k3.values()),
        **{f"{key}_m{m}": g[key] for m, g in k3.items() for key in ("launches", "ms", "bound_ms")},
    )
    print(f"K3 per SSP-3D batch: {records['coverage']['ssp3d_batch_ms']:.4f} ms against a bound of "
          f"{records['coverage']['ssp3d_batch_bound_ms']:.4f} ms")
    check_eval_against_cpu(model, smpls, cfg)
    print(f"SSP-3D protocol B={B} N={N} {IMG}²: {ssp3d_img_s:.2f} img/s over {PROTOCOL_BATCHES - 1} batches after a "
          f"warm-up; per batch eval step {split['eval_step_ms']:.2f} ms, silhouettes {split['silhouettes_ms']:.2f} ms, "
          f"metrics {split['metrics_ms']:.2f} ms")

    # ---- phase 7: the 3DPW protocol, B=32, N=10
    pw3d_final, path_launches["3DPW"], pw3d_img_s = run_protocol(model, smpls, cfg, EVAL_METRICS_3DPW, 10)
    if path_launches["3DPW"]["smpl_verts"] == 0:
        raise AssertionError("the 3DPW protocol did not launch K2")
    print(f"3DPW protocol B={B} N=10: {pw3d_img_s:.2f} img/s over {PROTOCOL_BATCHES - 1} batches after a warm-up")

    # ---- phase 8: K5 against its plain twin on every depth level
    records["flow_level"], k5_timing = check_flow_level(model, proxy)

    # ---- phase 9: the default route on the main path (K5 under inference mode)
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
    pw3d_f, c, _ = run_protocol(model, smpls, cfg, EVAL_METRICS_3DPW, 10)
    path_launches["3DPW, fused level"] = c
    if c["flow_level"] != PROTOCOL_BATCHES * len(model.levels):
        raise AssertionError(f"the 3DPW protocol on the default route launched K5 {c['flow_level']} times, not once a "
                             f"level of each of its {PROTOCOL_BATCHES} batches")
    worst = max(abs(pw3d_f[m] - w) / max(abs(w), 1e-30) for m, w in pw3d_final.items())
    print(f"3DPW protocol N=10 on the default route (K5, {c['flow_level']} launches) vs phase 7's eager flow: final "
          f"metrics within {worst:.3e} relative")
    if set(pw3d_f) != set(pw3d_final) or not worst <= METRIC_RTOL:
        raise AssertionError(f"the 3DPW protocol on the default route moves its metrics by {worst} relative")
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

    # ---- phase 10: uncropped-image predict, HRNet-W48 at 384×288, the default route (K5)
    ph = importlib.import_module("humaniflow_torch.pipelines.predict_hrnet")  # the module, not the function

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
        forward_ms = cuda_ms(lambda: ph.crop_keypoints(hrnet, out["cropped_images"]), 3)
        flops = _conv_flops(hrnet, out["cropped_images"])
        print(f"uncropped predict, HRNet {name}, B={B} N={N}: {B / total * 1e3:.2f} img/s ({total:.2f} ms/batch: "
              f"HRNet stage {split['hrnet']:.2f} ms over {passes} passes (one normalise → HRNet → decode pass "
              f"{forward_ms:.2f} ms, {flops / 1e12:.3f} TFLOP of convolutions, {flops / forward_ms / 1e9:.1f} "
              f"TFLOP/s; the rest is upload and 384×288 crops), proxy crops {split['crops']:.2f} ms, "
              f"predict {split['predict']:.2f} ms); {refined} of {B} boxes refined by the keypoint fallback")
        del hrnet

    # ---- phase 11: training
    _set_fused(False)
    records["raster"] = check_raster(smpl)
    check_smpl_verts_plans(smpl, records["smpl_verts"])
    records["smpl_verts_backward"] = check_smpl_backward(smpl)
    check_train_step_against_cpu(cfg)
    train_launches, train_timings = train_full_width(smpl, cfg)
    path_launches.update(train_launches)

    # ---- phases 12-14: K6, K7, and predict → optimise → visualise
    records["tiled_raster"] = check_tiled_raster(smpl)
    records["lbs_skin"] = check_lbs_skin()
    vis_launches, vis_timings = optimise_and_visualise(model, smpl, cfg, pred)
    path_launches.update(vis_launches)
    fig_k6 = [c for fig in ("point-estimate figure", "sample renders") for c in vis_timings[fig]["k6_launches"]]
    records["tiled_raster"].update(figure_launches=[{"meshes": m, "ms": ms, "bound_ms": bd} for m, ms, bd in fig_k6],
                                   figure_ms=sum(ms for _, ms, _ in fig_k6),
                                   figure_bound_ms=sum(bd for _, _, bd in fig_k6))

    # ---- phase 15: the flow menu, then the train and evaluate CLIs
    path_launches.update(flow_menu(smpl, cfg, proxy, train_timings))
    with tempfile.TemporaryDirectory() as cli_root:
        cli_launches, ckpt = train_and_evaluate_clis(train_timings, cli_root)
        path_launches.update(cli_launches)

        # ---- phase 16: the parallel layer (NCCL at world size 1, 2 gloo ranks on the card, the CLIs' flags)
        path_launches.update(multi_device(model, smpls, cfg, pred, verts_pe, vertex_var, (verts_pe_f, vertex_var_f),
                                          card, (cli_root, ckpt)))

        # ---- phase 17: data preparation (3DPW preprocessing, HRNet keypoints) to evaluation
        path_launches.update(prepare_pw3d(smpl, (cli_root, ckpt)))
    print(f"launches by path: {path_launches}")

    # ---- profiler measurements, last: a profiler session leaves the host
    # slower for the rest of the process.  K5's device time per level, then
    # the forward's device time and launches per batch in both settings.
    time_flow_level(model.flow, records["flow_level"], k5_timing)
    for on in (False, True):
        _set_fused(on)
        prof = device_profile(lambda: model_forward(gen.manual_seed(9)), iters=5)
        print(f"model forward, {flow_route(model)}: device busy {prof['device_busy_ms']:.2f} ms, "
              f"{prof['launches']:.0f} kernel launches per batch")
    _set_fused(False)
    profile_optimise(model, smpl, pred)
    profile_smpl_backward(smpl, records["smpl_verts_backward"])
    profile_kernel_device_times(smpl, records)

    kernels = []
    sources = {"smpl_verts": "csrc/smpl_lbs.cu", "smpl_moments": "csrc/smpl_lbs.cu", "coverage": "csrc/coverage.cu",
               "flow_level": "csrc/flow_level.cu", "raster": "csrc/raster.cu",
               # K2's backward: the per-vertex kernel, then float32 products (models/cuda_lbs.py)
               "smpl_verts_backward": "csrc/smpl_lbs.cu",
               "tiled_raster": "csrc/tiled_raster.cu",
               # no path calls K7, in the JAX package or here (launches 0)
               "lbs_skin": "csrc/lbs_skin.cu"}
    for name, source in sources.items():
        rec = records[name]
        extra = {k: v for k, v in rec.items() if k not in ("name", "replaces", "max_abs_err", "ms", "plain_ms",
                                                            "bound_ms", "bound_by", "library_ms")}
        kernels.append(dict(
            name=name, route="cuda", source=f"humaniflow_torch/{source}", replaces=rec["replaces"],
            launches=sum(c[name] for c in path_launches.values()), max_abs_err=rec["max_abs_err"], ms=rec["ms"],
            plain_ms=rec["plain_ms"], bound_ms=rec["bound_ms"], bound_by=rec["bound_by"],
            library_ms=rec.get("library_ms"), **extra,
        ))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
