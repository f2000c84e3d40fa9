#!/usr/bin/env python3
"""Smoke test of the PyTorch port (humaniflow_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0):
1. print the card's name and power limit; build the CUDA kernels with nvcc
   (into build/torch_kernels/);
2. hold kernels K2 (smpl_verts) and K1 (smpl_moments) against their plain
   PyTorch twins at the main path's shapes and at ragged ones, and time both;
3. drive the main path through predict_humaniflow at the full width of the
   default model (ResNet-18, 256² proxy, 8-level flow, synthetic SMPL with
   6890 vertices; seeded random weights), B=32 images, N=100 samples, and
   check its outputs against the CPU path on a small input;
4. run the distribution-inference program (model → K1 moments → variance,
   plus the K2 point estimate) at B=32, N=100 and check its variance
   against predict's vertex samples drawn with the same noise.

The kernel launch counters are zeroed just before phase 3 and read after
phase 4.  Prints one {"kernels": [...]} line, then the card line as
nvidia-smi gives it, and last {"ok": true, "device": {...}}.  Without CUDA,
or without the humaniflow_torch package beside it, it exits non-zero and
prints no result.
"""

import json
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


def main() -> int:
    import torch

    import humaniflow_torch  # noqa: F401  (fails outside the repository)

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmuls are on; the port needs them off")
    from humaniflow_torch.configs import get_humaniflow_cfg_defaults
    from humaniflow_torch.models import HumaniflowModel, cuda_lbs, smpl_forward, smpl_vertex_moments, synthetic_smpl
    from humaniflow_torch.pipelines import predict_humaniflow
    from humaniflow_torch.utils.cuda_build import build_all
    from humaniflow_torch.utils.profiling import cuda_ms, wall_ms

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
    for k in cuda_lbs.LAUNCHES:
        cuda_lbs.LAUNCHES[k] = 0
    pred = predict_humaniflow(model, smpl, cfg, images, joints2d, conf, num_samples=N,
                              generator=torch.Generator("cuda").manual_seed(7))
    torch.cuda.synchronize()
    if cuda_lbs.LAUNCHES["smpl_verts"] == 0:
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

    verts_pe, vertex_var = distribution_inference(7)
    torch.cuda.synchronize()
    launches = dict(cuda_lbs.LAUNCHES)
    if launches["smpl_moments"] == 0:
        raise AssertionError("the distribution-inference program did not launch K1")
    want_var = (pred["vertex_uncertainty_directional"] ** 2).sum(-1)
    var_err = float((vertex_var - want_var).abs().max())
    print(f"variance from K1 moments vs predict's samples: max abs diff {var_err:.3e} m^2 "
          f"(variance up to {float(want_var.max()):.3e})")
    torch.testing.assert_close(vertex_var, want_var, rtol=VAR_RTOL, atol=VAR_ATOL)
    torch.testing.assert_close(verts_pe, pred["verts_point_est"], rtol=0, atol=VERTS_ATOL)
    print(f"main-path launches: {launches}")

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

    kernels = []
    for name in ("smpl_verts", "smpl_moments"):
        rec = records[name]
        kernels.append(dict(
            name=name, route="cuda", source="humaniflow_torch/csrc/smpl_lbs.cu", replaces=rec["replaces"],
            launches=launches[name], max_abs_err=rec["max_abs_err"], ms=rec["ms"], plain_ms=rec["plain_ms"],
            bound_ms=rec["bound_ms"], bound_by=rec["bound_by"], library_ms=None,
        ))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
