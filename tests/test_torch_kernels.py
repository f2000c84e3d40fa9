"""Kernels K1 (smpl_moments) and K2 (smpl_verts) of csrc/smpl_lbs.cu, K3
(coverage) of csrc/coverage.cu and K5 (flow_level) of csrc/flow_level.cu
against their plain PyTorch twins, on an NVIDIA GPU.

Every test here is marked `cuda` and skips without a card.  The file imports
nothing of JAX, so that it also runs where JAX is not installed:

    python -m pytest tests/test_torch_kernels.py -q --noconftest
"""

import math

import pytest
import torch

from humaniflow_torch.models import cuda_lbs
from humaniflow_torch.render import cuda_coverage

# Kernel against plain twin: 2e-5 m for vertices (float32 sums in another
# order); moments 1e-5 relative to each moment plane's largest value; K3's
# masks bit for bit (the same rounded operations in the same order).
VERT_ATOL = 2e-5
MOM_RTOL = 1e-5


def _require_cuda():
    """Skip unless a CUDA device is present; decided at run time so that
    every test worker collects the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")


def _kernel_inputs_cuda(rows, v, nb=10, seed=0):
    g = torch.Generator("cuda").manual_seed(seed)
    r = lambda *s, sc=1.0: torch.randn(*s, generator=g, device="cuda") * sc  # noqa: E731
    return (
        r(*rows, 24, 12, sc=0.5), r(*rows, nb), r(*rows, 207, sc=0.5),
        r(3, v, sc=0.3), r(nb, 3, v, sc=0.01), r(207, 3, v, sc=0.001),
        torch.softmax(r(v, 24, sc=3.0), -1),
    )


@pytest.mark.cuda
@pytest.mark.parametrize("rows,v", [((37,), 1000), ((3200,), 6890)])
def test_smpl_verts_kernel_matches_plain(rows, v):
    _require_cuda()
    args = _kernel_inputs_cuda(rows, v)
    before = cuda_lbs.LAUNCHES["smpl_verts"]
    got = cuda_lbs.smpl_verts(*args)
    torch.cuda.synchronize()
    assert cuda_lbs.LAUNCHES["smpl_verts"] == before + 1
    torch.testing.assert_close(got, cuda_lbs.smpl_verts_plain(*args), rtol=0, atol=VERT_ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,v", [((3, 7), 1000), ((32, 100), 6890)])
def test_smpl_moments_kernel_matches_plain(rows, v):
    _require_cuda()
    args = _kernel_inputs_cuda(rows, v)
    before = cuda_lbs.LAUNCHES["smpl_moments"]
    got = cuda_lbs.smpl_moments(*args)
    torch.cuda.synchronize()
    assert cuda_lbs.LAUNCHES["smpl_moments"] == before + 1
    want = cuda_lbs.smpl_verts_moments_plain(*args)
    scale = want.abs().amax(dim=(0, 2, 3), keepdim=True)
    assert float(((got - want).abs() / scale).max()) <= MOM_RTOL


@pytest.mark.cuda
def test_kernel_wrappers_reject_bad_inputs():
    _require_cuda()
    args = list(_kernel_inputs_cuda((4,), 256))
    bad = {
        "dtype": lambda a: a.double(),
        "layout": lambda a: a.transpose(0, 1).contiguous().transpose(0, 1),
        "device": lambda a: a.cpu(),
    }
    for name, f in bad.items():
        broken = list(args)
        broken[3] = f(args[3])  # v_template_cm
        with pytest.raises((TypeError, ValueError)):
            cuda_lbs.smpl_verts(*broken)
    with pytest.raises(ValueError):
        cuda_lbs.smpl_verts(args[0][:, :23], *args[1:])


def _posed_screen(img, b=6, seed=0):
    """DensePose-vertex screen coordinates of b posed synthetic bodies."""
    from humaniflow_torch.models import smpl_forward, synthetic_smpl
    from humaniflow_torch.ops import so3_exp
    from humaniflow_torch.render import TexturedIUVRenderer

    g = torch.Generator("cuda").manual_seed(seed)
    smpl = synthetic_smpl(num_verts=6890)
    pose = so3_exp(0.25 * torch.randn((b, 23, 3), generator=g, device="cuda"))
    shape = torch.randn((b, 10), generator=g, device="cuda")
    verts = smpl_forward(smpl, shape, pose, torch.eye(3, device="cuda").expand(b, 3, 3))["vertices"]
    cam = torch.tensor([0.9, 0.0, 0.2], device="cuda").expand(b, 3).clone()
    renderer = TexturedIUVRenderer(img_wh=img, render_rgb=False)
    return renderer._sil_screen(verts, cam).contiguous(), renderer.dp["faces"]


def _ragged_screen(img):
    """Hand-made faces: ordinary, zero-area, off screen, crossing the border,
    stretched, with a NaN vertex and with an index out of range."""
    v = torch.tensor(
        [[3.2, 4.1, 0], [17.9, 6.3, 0], [8.0, 21.7, 0],  # ordinary
         [30.5, 30.5, 0], [40.5, 40.5, 0], [50.5, 50.5, 0],  # collinear: zero area
         [-90.0, -80.0, 0], [-60.0, -85.0, 0], [-70.0, -50.0, 0],  # off screen
         [-20.0, 100.0, 0], [img + 30.0, 110.0, 0], [img / 2, 150.0, 0],  # crosses both borders
         [1.5, img - 2.5, 0], [img - 1.5, img - 2.0, 0], [img / 2, img - 1.0, 0],  # stretched
         [math.nan, 10.0, 0], [20.0, 10.0, 0], [15.0, 30.0, 0]],  # NaN vertex
        device="cuda",
    )
    faces = torch.arange(18, dtype=torch.int32, device="cuda").reshape(6, 3)
    faces = torch.cat([faces, faces.flip(1), torch.tensor([[0, 1, 99]], dtype=torch.int32, device="cuda")])
    return torch.stack([v, v + 0.37]).contiguous(), faces.contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("img", [256, 200])
@pytest.mark.parametrize("cull_sign", [0, 1])
def test_coverage_kernel_matches_plain_bit_for_bit(img, cull_sign):
    _require_cuda()
    for sv, faces in (_posed_screen(img), _ragged_screen(img)):
        before = cuda_coverage.LAUNCHES["coverage"]
        mask, overflow = cuda_coverage.coverage(sv, faces, img, cull_sign=cull_sign)
        torch.cuda.synchronize()
        assert cuda_coverage.LAUNCHES["coverage"] == before + 1
        want_mask, want_overflow = cuda_coverage.coverage_plain(sv, faces, img, cull_sign=cull_sign)
        assert mask.dtype == torch.bool and mask.shape == want_mask.shape
        assert int((mask != want_mask).sum()) == 0
        assert torch.equal(overflow, want_overflow)
        assert bool(mask.any())
    assert overflow.tolist() == [1, 1]  # the ragged set's out-of-range face


@pytest.mark.cuda
def test_coverage_wrapper_rejects_bad_inputs():
    _require_cuda()
    sv, faces = _ragged_screen(64)
    bad = [
        (sv.double(), faces), (sv, faces.long()), (sv, faces.cpu()),
        (sv.transpose(0, 1).contiguous().transpose(0, 1), faces), (sv[..., :2].contiguous(), faces),
        (sv, faces[:, :2].contiguous()),
    ]
    for args in bad:
        with pytest.raises((TypeError, ValueError)):
            cuda_coverage.coverage(*args, 64)
    with pytest.raises(ValueError):
        cuda_coverage.coverage(sv, faces, 64, cull_sign=2)


# K5 (flow_level): kernel against its plain twin, 2e-5 abs (the JAX package's
# Mosaic-vs-XLA bound for the fused level; float32 sums in another order).
LEVEL_ATOL = 2e-5


def _flow_model():
    from humaniflow_torch.configs import get_humaniflow_cfg_defaults
    from humaniflow_torch.models import HumaniflowModel

    return HumaniflowModel(get_humaniflow_cfg_defaults().MODEL, generator=torch.Generator().manual_seed(0))


def _level_inputs_cuda(p, rows, c, seed):
    """z: 0.6·N(0, 1), with mode rows (0) and tail rows (±10) first; ctx
    ELU(N(0, 1)) as the model's contexts."""
    g = torch.Generator("cuda").manual_seed(seed)
    z = 0.6 * torch.randn((rows, p, 3), generator=g, device="cuda")
    z[:4] = 0.0
    z[4:8] = 10.0
    z[8:12] = -10.0
    ctx = torch.nn.functional.elu(torch.randn((rows, p, c), generator=g, device="cuda"))
    return z, ctx


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 33, 3239])
def test_flow_level_kernel_matches_plain_on_every_level(rows):
    _require_cuda()
    from humaniflow_torch.flows import cuda_level

    model = _flow_model()
    for li, parts in enumerate(model.levels):
        idx = getattr(model, f"level_parts_{li}")
        z, ctx = _level_inputs_cuda(len(parts), rows, 64, seed=li)
        before = cuda_level.LAUNCHES["flow_level"]
        with torch.inference_mode():
            got = cuda_level.flow_forward_level(model.flow, z, ctx, idx)
            torch.cuda.synchronize()
            want = cuda_level.flow_forward_level_plain(model.flow, z, ctx, idx)
        assert cuda_level.LAUNCHES["flow_level"] == before + 1
        torch.testing.assert_close(got, want, rtol=0, atol=LEVEL_ATOL, msg=f"level {li}")


@pytest.mark.cuda
def test_flow_level_wrapper_rejects_bad_inputs():
    _require_cuda()
    from humaniflow_torch.flows import cuda_level

    model = _flow_model()
    idx = model.level_parts_3
    z, ctx = _level_inputs_cuda(len(idx), 16, 64, seed=0)
    bad = [
        (z.double(), ctx, idx), (z, ctx.transpose(0, 1).contiguous().transpose(0, 1), idx), (z, ctx, idx.cpu()),
        (z, ctx, idx.int()), (z, ctx[..., :32].contiguous(), idx), (z[:8], ctx, idx), (z.cpu().cuda(), ctx.cpu(), idx),
    ]
    for args in bad:
        with pytest.raises((TypeError, ValueError)):
            cuda_level.flow_forward_level(model.flow, *args)


@pytest.mark.cuda
def test_fused_level_model_on_the_card(monkeypatch):
    """apply(num_samples=N) with HFT_FUSED_LEVEL=1 launches K5 once per level
    and agrees with the eager flow (2e-4, the JAX fused-vs-XLA bound)."""
    _require_cuda()
    from humaniflow_torch.flows import cuda_level

    model = _flow_model()
    proxy = torch.rand((4, 64, 64, 18), generator=torch.Generator("cuda").manual_seed(1), device="cuda")
    noise = model._draw_level_noise((4, 10), torch.Generator("cuda").manual_seed(2))
    with torch.inference_mode():
        monkeypatch.setenv("HFT_FUSED_LEVEL", "0")
        want = model.apply(proxy, num_samples=10, base_noise=noise, use_shape_mode_for_samples=True)
        monkeypatch.setenv("HFT_FUSED_LEVEL", "1")
        before = cuda_level.LAUNCHES["flow_level"]
        got = model.apply(proxy, num_samples=10, base_noise=noise, use_shape_mode_for_samples=True)
        torch.cuda.synchronize()
    assert cuda_level.LAUNCHES["flow_level"] == before + len(model.levels)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=2e-4, msg=k)
