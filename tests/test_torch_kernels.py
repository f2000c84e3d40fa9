"""Kernels K1 (smpl_moments) and K2 (smpl_verts, with its backward kernel)
of csrc/smpl_lbs.cu, K3 (coverage) of csrc/coverage.cu, K4 (raster) of
csrc/raster.cu, K5 (flow_level) of csrc/flow_level.cu, K6 (tiled_raster) of
csrc/tiled_raster.cu and K7 (lbs_skin, with its gradient) of
csrc/lbs_skin.cu against their plain PyTorch twins, on an NVIDIA GPU; the
kernels without a backward refusing inputs that require grad; and
distribution inference replayed as one CUDA graph against its eager body.

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
# masks and K6's fragments bit for bit (the same rounded operations in the
# same order); K7 2e-6 (FMAs against the twin's einsum), its gradient 1e-5
# of the largest.
VERT_ATOL = 2e-5
MOM_RTOL = 1e-5
LBS_ATOL, LBS_GRAD_RTOL = 2e-6, 1e-5


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
@pytest.mark.parametrize("v", [1000, 6890])
@pytest.mark.parametrize("rows", [1, 17, 32, 33, 72, 320, 576, 3232])
def test_smpl_verts_kernel_matches_plain_at_every_plan(rows, v):
    """K2's forward at the paths' row counts and ragged ones, each through
    the tile models/cuda_lbs.py::forward_plan picks for it, one launch."""
    _require_cuda()
    args = _kernel_inputs_cuda((rows,), v, seed=rows)
    before = cuda_lbs.LAUNCHES["smpl_verts"]
    got = cuda_lbs.smpl_verts(*args)
    torch.cuda.synchronize()
    assert cuda_lbs.LAUNCHES["smpl_verts"] == before + 1
    torch.testing.assert_close(got, cuda_lbs.smpl_verts_plain(*args), rtol=0, atol=VERT_ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,v", [((1, 1), 1000), ((3, 7), 1000), ((2, 17), 6890), ((32, 10), 6890),
                                    ((32, 100), 6890), ((4, 101), 6890)])
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
@pytest.mark.parametrize("rows, v", [((3, 7), 1000), ((3, 4), 1000), ((5, 17), 1000), ((4, 101), 6890),
                                     ((32, 100), 6890)])
def test_smpl_moments_matches_plain_and_repeats_its_bits(rows, v):
    """K1 within the tolerance of the twin at ragged and full-width shapes
    (N % 16 of 7, 4, 1, 5 and 4, so with and without the blocks that take
    four groups' last rows; G not a multiple of 4), and the same bits on two
    launches."""
    _require_cuda()
    args = _kernel_inputs_cuda(rows, v, seed=1)
    got = cuda_lbs.smpl_moments(*args)
    again = cuda_lbs.smpl_moments(*args)
    torch.cuda.synchronize()
    want = cuda_lbs.smpl_verts_moments_plain(*args)
    scale = want.abs().amax(dim=(0, 2, 3), keepdim=True)
    assert float(((got - want).abs() / scale).max()) <= MOM_RTOL
    assert torch.equal(got, again)


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


K3_CASES = [  # the names of tests/_torch_cases.py::coverage_cases
    "whole-image face", "all culled, and its mirror all kept",
    "band borders at 1024², NaN vertex, 2 indices out of range", "33², ragged word", "200², ragged word",
    "M=1", "M=257", "2,000 large boxes",
]


@pytest.mark.cuda
@pytest.mark.parametrize("name", K3_CASES)
def test_coverage_kernel_matches_plain_on_edge_cases(name):
    """Bands, cluster shares, the warp walk's two box shapes, the queue of
    large boxes, ragged mask words and the overflow count, bit for bit."""
    _require_cuda()
    from _torch_cases import coverage_cases

    sv, faces, img, cull = coverage_cases("cuda")[name]
    mask, overflow = cuda_coverage.coverage(sv, faces, img, cull_sign=cull)
    torch.cuda.synchronize()
    want_mask, want_overflow = cuda_coverage.coverage_plain(sv, faces, img, cull_sign=cull)
    assert int((mask != want_mask).sum()) == 0
    assert torch.equal(overflow, want_overflow)
    if name.startswith("band borders"):
        assert overflow.tolist() == [2, 2, 2]  # once per mesh, not once per band or block
    if name.startswith("all culled"):
        assert not bool(mask[0].any()) and bool(mask[1].any())


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


def _flow_model(seed=0):
    from humaniflow_torch.configs import get_humaniflow_cfg_defaults
    from humaniflow_torch.models import HumaniflowModel

    return HumaniflowModel(get_humaniflow_cfg_defaults().MODEL, generator=torch.Generator().manual_seed(seed))


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
@pytest.mark.parametrize("rows", [1, 31, 32, 33, 3232, 3239])
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
def test_flow_level_kernel_matches_plain_at_ragged_row_counts():
    """Each level at row counts one below, at and one above multiples of the
    16-row warp tile and of the 64-row block: blocks with idle warps and
    warps with idle rows."""
    _require_cuda()
    from humaniflow_torch.flows import cuda_level

    model = _flow_model()
    for li, parts in enumerate(model.levels):
        idx = getattr(model, f"level_parts_{li}")
        p = len(parts)
        for rows in sorted({m + d for m in (16, 48, 64, 80, 128, 192) for d in (-1, 0, 1)}):
            z, ctx = _level_inputs_cuda(p, rows, 64, seed=rows)
            with torch.inference_mode():
                got = cuda_level.flow_forward_level(model.flow, z, ctx, idx)
                torch.cuda.synchronize()
                want = cuda_level.flow_forward_level_plain(model.flow, z, ctx, idx)
            torch.testing.assert_close(got, want, rtol=0, atol=LEVEL_ATOL, msg=f"level {li}, rows {rows}")


@pytest.mark.cuda
def test_flow_level_kernel_matches_plain_at_wide_and_odd_widths():
    """A flow of hidden widths 128 and 40 (the 16-n-tile register tile, an
    n-tile count that is not a power of two) on 37 context features (read
    one float at a time), 5 parts, ragged rows."""
    _require_cuda()
    from humaniflow_torch.flows import cuda_level
    from humaniflow_torch.flows.factory import create_conditional_norm_flow

    flow = create_conditional_norm_flow(event_dim=3, context_dim=37, num_transforms=2, num_parts=6,
                                        transform_hidden_dims=(128, 40), radial_tanh_radius=1.5 * math.pi)
    g = torch.Generator().manual_seed(4)
    for m in flow.transforms:
        if hasattr(m, "hypernet"):
            m.hypernet.reset_parameters(g)
    flow.cuda()
    idx = torch.tensor([5, 0, 3, 1, 2], device="cuda")
    for rows in (1, 50, 1001):
        z, ctx = _level_inputs_cuda(len(idx), rows, 37, seed=rows)
        with torch.inference_mode():
            got = cuda_level.flow_forward_level(flow, z, ctx, idx)
            torch.cuda.synchronize()
            want = cuda_level.flow_forward_level_plain(flow, z, ctx, idx)
        torch.testing.assert_close(got, want, rtol=0, atol=LEVEL_ATOL, msg=f"rows {rows}")


@pytest.mark.cuda
def test_flow_level_kernel_follows_an_in_place_load_state_dict():
    """Two calls with new weights loaded in place between them (the same
    storage, a new version): the second call matches the twin with the new
    weights, not the pack of the old ones."""
    _require_cuda()
    from humaniflow_torch.configs import get_humaniflow_cfg_defaults
    from humaniflow_torch.flows import cuda_level
    from humaniflow_torch.models import HumaniflowModel

    model = _flow_model()
    other = HumaniflowModel(get_humaniflow_cfg_defaults().MODEL, generator=torch.Generator().manual_seed(1))
    idx = model.level_parts_3
    z, ctx = _level_inputs_cuda(len(idx), 500, 64, seed=3)
    with torch.inference_mode():
        first = cuda_level.flow_forward_level(model.flow, z, ctx, idx)
    model.flow.load_state_dict(other.flow.state_dict())
    with torch.inference_mode():
        got = cuda_level.flow_forward_level(model.flow, z, ctx, idx)
        torch.cuda.synchronize()
        want = cuda_level.flow_forward_level_plain(model.flow, z, ctx, idx)
    torch.testing.assert_close(got, want, rtol=0, atol=LEVEL_ATOL)
    assert float((got - first).abs().max()) > 1e-3  # the new weights moved the outputs


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


def _refuse_k5(monkeypatch):
    """The eager flow for every model while the patch holds: supports_flow
    refuses, so the route (models/humaniflow.py) never takes K5."""
    from humaniflow_torch.flows import cuda_level

    monkeypatch.setattr(cuda_level, "supports_flow", lambda flow: False)


@pytest.mark.cuda
def test_fused_level_model_on_the_card(monkeypatch):
    """apply(num_samples=N) on the default route launches K5 once per level
    and agrees with the eager flow (2e-4, the JAX fused-vs-XLA bound), which
    a refusing supports_flow forces."""
    _require_cuda()
    from humaniflow_torch.flows import cuda_level

    model = _flow_model()
    proxy = torch.rand((4, 64, 64, 18), generator=torch.Generator("cuda").manual_seed(1), device="cuda")
    noise = model._draw_level_noise((4, 10), torch.Generator("cuda").manual_seed(2))
    with torch.inference_mode():
        with monkeypatch.context() as m:
            _refuse_k5(m)
            want = model.apply(proxy, num_samples=10, base_noise=noise, use_shape_mode_for_samples=True)
        before = cuda_level.LAUNCHES["flow_level"]
        got = model.apply(proxy, num_samples=10, base_noise=noise, use_shape_mode_for_samples=True)
        torch.cuda.synchronize()
    assert cuda_level.LAUNCHES["flow_level"] == before + len(model.levels)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=2e-4, msg=k)


# The prediction cells' `rotations` limit (benchmark/traffic/crops_b32_n100.json).
CELL_ROT_ATOL = 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1])
def test_default_route_matches_eager_at_the_prediction_cells_shape(monkeypatch, seed):
    """apply(B=32, N=100) under inference_mode at the default widths: on the
    default route the pass takes K5, 8 launches, and its rotations stay
    within the prediction cells' limit of the eager flow (which a refusing
    supports_flow forces).  Seeded U(±1/√fan_in) dense weights, as the
    benchmark draws them."""
    _require_cuda()
    from humaniflow_torch.flows import cuda_level

    b, n = 32, 100
    model = _flow_model(seed)
    g = torch.Generator("cuda").manual_seed(10 + seed)
    proxy = torch.rand((b, 256, 256, 18), generator=g, device="cuda")
    noise = model._draw_level_noise((b, n), g)
    shape_noise = torch.randn((b, n, model.cfg.NUM_SMPL_BETAS), generator=g, device="cuda")
    kw = dict(num_samples=n, base_noise=noise, shape_noise=shape_noise)
    with torch.inference_mode():
        before = cuda_level.LAUNCHES["flow_level"]
        with monkeypatch.context() as m:
            _refuse_k5(m)
            want = model.apply(proxy, **kw)
        assert cuda_level.LAUNCHES["flow_level"] == before
        got = model.apply(proxy, **kw)
        torch.cuda.synchronize()
    assert cuda_level.LAUNCHES["flow_level"] == before + len(model.levels) == before + 8
    for k in ("pose_rotmats_point_est", "pose_rotmats_samples"):
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=CELL_ROT_ATOL, msg=k)


# Distribution inference as one CUDA graph (pipelines/predict.py): each call
# of the graphed function against `_predict_body` run eagerly on the same
# inputs, bit for bit, at the r18 cell's (B, N) and the uncropped cells'.
GRAPH_SHAPES = [(32, 100), (32, 50)]


def _graph_case(b, n, seed=0):
    """A default-width model on the card, SMPL at V = 6890, the graphed
    predict function at N and a pool of three (proxy, noise) batches of B."""
    from humaniflow_torch.configs import get_humaniflow_cfg_defaults
    from humaniflow_torch.models import synthetic_smpl
    from humaniflow_torch.pipelines import predict as tpredict

    model, smpl = _flow_model(seed), synthetic_smpl(num_verts=6890)
    g = torch.Generator("cuda").manual_seed(20 + seed)
    pool = [(torch.rand((b, 256, 256, 18), generator=g, device="cuda"), model._draw_level_noise((b, n), g))
            for _ in range(3)]
    return model, smpl, tpredict.make_predict_fn(model, smpl, get_humaniflow_cfg_defaults(), num_samples=n), pool


def _eager_prediction(model, smpl, n, proxy, noise=None, generator=None):
    from humaniflow_torch.pipelines import predict as tpredict

    with torch.inference_mode():
        return tpredict._predict_body(model, smpl, n, True, None, proxy, generator, noise)


def _assert_same_bits(got, want, what):
    assert set(got) == set(want), what
    for k in want:
        assert torch.equal(got[k], want[k]), f"{what}: {k}"


def _launches():
    from humaniflow_torch.flows import cuda_level

    return cuda_level.LAUNCHES["flow_level"], cuda_lbs.LAUNCHES["smpl_verts"]


@pytest.mark.cuda
@pytest.mark.parametrize("noise_from", ["explicit noise", "a generator"])
@pytest.mark.parametrize("b,n", GRAPH_SHAPES)
def test_graphed_prediction_is_the_eager_body_bit_for_bit(b, n, noise_from):
    """The capture (which returns its eager warm-up), the first replay and a
    later replay, each on another pool batch, equal the eager body; call 1's
    outputs are unchanged after calls 2 and 3.  K5's and K2's wrappers count
    the warm-up's 8 and 3 launches and none of the capture's or a replay's
    (the device trace sees a replay's kernels: the test below)."""
    _require_cuda()
    model, smpl, predict, pool = _graph_case(b, n)
    got, copies = [], []
    for i, (proxy, noise) in enumerate(pool):
        before = _launches()
        if noise_from == "explicit noise":
            out = predict(proxy, None, noise)
        else:
            out = predict(proxy, torch.Generator("cuda").manual_seed(i))
        torch.cuda.synchronize()
        assert tuple(a - c for a, c in zip(_launches(), before)) == ((8, 3) if i == 0 else (0, 0)), f"call {i + 1}"
        got.append(out)
        copies.append({k: v.clone() for k, v in out.items()})
    for i, ((proxy, noise), out, copy) in enumerate(zip(pool, got, copies)):
        gen = torch.Generator("cuda").manual_seed(i) if noise_from == "a generator" else None
        want = _eager_prediction(model, smpl, n, proxy, None if gen is not None else noise, gen)
        _assert_same_bits(out, want, f"call {i + 1}")
        _assert_same_bits(out, copy, f"call {i + 1} after the later calls")


@pytest.mark.cuda
@pytest.mark.parametrize("b,n", GRAPH_SHAPES)
def test_a_replay_runs_k5_and_k2_inside_the_graph(b, n):
    """One replay under torch.profiler: the device ran K5's 8 levels and K2's
    3 calls (the point estimate, the T-pose, the B·N samples) by their
    kernels' names, though no wrapper launched them."""
    _require_cuda()
    from humaniflow_torch.utils import tracing
    from _torch_cases import kernel_counts

    model, smpl, predict, pool = _graph_case(b, n)
    (proxy, noise), (proxy2, noise2) = pool[:2]
    predict(proxy, None, noise)  # the capture
    torch.cuda.synchronize()
    before = _launches()
    tracing.reset()
    with tracing.tracing():
        seen = kernel_counts(lambda: predict(proxy2, None, noise2), ("flow_level_kernel", "smpl_verts_kernel"))
    assert set(tracing.summary()["dist_infer"]["counters"]) == {"graph_replays"}  # more if the profiler retried
    assert seen == {"flow_level_kernel": 8, "smpl_verts_kernel": 3}
    assert _launches() == before


@pytest.mark.cuda
@pytest.mark.parametrize("b,n", GRAPH_SHAPES)
def test_graphed_prediction_replays_an_in_place_write_outside_the_hypernet(b, n):
    """The encoder's weights written in place after a capture and a replay:
    the next call is a replay (the graph reads them where they lie, and K5's
    pack is unchanged) and equals the eager body under the new weights."""
    _require_cuda()
    from humaniflow_torch.utils import tracing

    model, smpl, predict, pool = _graph_case(b, n)
    for proxy, noise in pool[:2]:
        old = predict(proxy, None, noise)
    with torch.no_grad():
        for p in model.encoder.parameters():
            p.mul_(1.5)
    tracing.reset()
    with tracing.tracing():
        got = predict(proxy, None, noise)
    assert tracing.summary()["dist_infer"]["counters"] == {"graph_replays": 1}
    _assert_same_bits(got, _eager_prediction(model, smpl, n, proxy, noise), "after the encoder's write")
    assert not torch.equal(got["input_feats"], old["input_feats"])


@pytest.mark.cuda
@pytest.mark.parametrize("b,n", GRAPH_SHAPES)
def test_graphed_prediction_follows_an_in_place_load_state_dict(b, n):
    """New weights loaded in place after a capture and a replay: the next
    call is the eager body under the new weights, so neither K5's old pack
    nor any stale address leaks into it."""
    _require_cuda()
    model, smpl, predict, pool = _graph_case(b, n)
    for proxy, noise in pool[:2]:
        old = predict(proxy, None, noise)
    model.load_state_dict(_flow_model(1).state_dict())
    proxy, noise = pool[1]
    got = predict(proxy, None, noise)
    _assert_same_bits(got, _eager_prediction(model, smpl, n, proxy, noise), "after load_state_dict")
    assert float((got["pose_rotmats_samples"] - old["pose_rotmats_samples"]).abs().max()) > 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("b,n", GRAPH_SHAPES)
def test_graphed_prediction_follows_the_fused_level_switch(monkeypatch, b, n):
    """The route follows supports_flow, the switch of the fused level: made to
    refuse after a capture and a replay, the next call runs the eager body
    with the eager flow (no K5 launch, off the graph route) and equals it."""
    _require_cuda()
    model, smpl, predict, pool = _graph_case(b, n)
    for proxy, noise in pool[:2]:
        predict(proxy, None, noise)
    _refuse_k5(monkeypatch)
    proxy, noise = pool[2]
    before = _launches()
    got = predict(proxy, None, noise)
    torch.cuda.synchronize()
    assert tuple(a - c for a, c in zip(_launches(), before)) == (0, 3)
    _assert_same_bits(got, _eager_prediction(model, smpl, n, proxy, noise), "supports_flow refusing")



# K4 (raster): kernel against its plain twin, bit for bit in depth, winners,
# barycentrics and planes (the same rounded operations in the same order).


def _raster_attrs(f, n_lin, n_const, seed, meshes=1):
    g = torch.Generator("cuda").manual_seed(seed)
    return torch.randn((meshes, f, 3 * n_lin + n_const), generator=g, device="cuda").contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("img", [256, 200])
@pytest.mark.parametrize("cull_sign", [-1, 0, 1])
def test_raster_kernel_matches_plain_bit_for_bit(img, cull_sign):
    _require_cuda()
    from humaniflow_torch.render import cuda_raster

    posed, faces = _posed_screen(img)
    ragged, ragged_faces = _ragged_screen(img)
    cases = [
        ("posed, training flags", posed, faces, dict(attrs=_raster_attrs(len(faces), 0, 4, 1, len(posed)),
                                                      emit_frags=False)),
        ("posed, frags + z_grads", posed, faces, dict(attrs=_raster_attrs(len(faces), 2, 1, 2), n_lin=2,
                                                       z_grads=True)),
        ("posed, no attributes", posed, faces, dict()),
        ("ragged", ragged, ragged_faces, dict(attrs=_raster_attrs(len(ragged_faces), 1, 2, 3), n_lin=1,
                                              z_grads=True)),
    ]
    for name, sv, f, kw in cases:
        before = cuda_raster.LAUNCHES["raster"]
        got = cuda_raster.raster(sv, f, img, cull_sign=cull_sign, **kw)
        torch.cuda.synchronize()
        assert cuda_raster.LAUNCHES["raster"] == before + 1
        want = cuda_raster.raster_plain(sv, f, img, cull_sign=cull_sign, **kw)
        depth, frags, planes, overflow = got
        assert torch.equal(depth, want[0]), name
        assert (frags is None) == (want[1] is None), name
        if frags is not None:
            for a, b in zip(frags, want[1]):
                assert torch.equal(a, b), name
        assert (planes is None) == (want[2] is None), name
        if planes is not None:
            assert torch.equal(planes, want[2]), name
        assert torch.equal(overflow, want[3]), name
        assert bool((depth < 1e9).any()), name
    assert overflow.tolist() == [1, 1]  # the ragged set's out-of-range face


def _assert_raster_equal(got, want, name):
    """K4's outputs equal its twin's bit for bit: depth, fragments, planes
    and overflow."""
    depth, frags, planes, overflow = got
    assert torch.equal(depth, want[0]), name
    assert (frags is None) == (want[1] is None), name
    if frags is not None:
        for a, b in zip(frags, want[1]):
            assert torch.equal(a, b), name
    assert (planes is None) == (want[2] is None), name
    if planes is not None:
        assert torch.equal(planes, want[2]), name
    assert torch.equal(overflow, want[3]), name


def _raster_both(sv, faces, img, **kw):
    """K4 (one launch, counted) and its twin on the same arguments."""
    from humaniflow_torch.render import cuda_raster

    before = cuda_raster.LAUNCHES["raster"]
    got = cuda_raster.raster(sv, faces, img, **kw)
    torch.cuda.synchronize()
    assert cuda_raster.LAUNCHES["raster"] == before + 1
    return got, cuda_raster.raster_plain(sv, faces, img, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("img", [200, 256, 384, 1024])
def test_raster_kernel_matches_plain_across_tiles(img):
    """Image sizes whose tile plan has several row tiles (200, 256) and
    several column tiles too (384, 1024): posed bodies, and at 1024² the
    faces across band borders of tests/_torch_cases.py::coverage_cases (a NaN
    vertex, two indices out of range)."""
    _require_cuda()
    from humaniflow_torch.render import cuda_raster
    from _torch_cases import coverage_cases

    _, _, row_tiles, col_tiles = cuda_raster.tile_plan(img)
    assert row_tiles > 1 and (col_tiles > 1) == (img > cuda_raster.TILE_COLS)
    if img <= 384:
        sv, faces = _posed_screen(img, b=3, seed=img)
    else:
        sv, faces, _, _ = coverage_cases("cuda")["band borders at 1024², NaN vertex, 2 indices out of range"]
    f = faces.shape[0]
    for name, kw in (("training flags", dict(attrs=_raster_attrs(f, 0, 4, 1, sv.shape[0]), emit_frags=False,
                                             cull_sign=1)),
                     ("fragments, 2 linear + 1 constant, z_grads", dict(attrs=_raster_attrs(f, 2, 1, 2), n_lin=2,
                                                                        z_grads=True))):
        got, want = _raster_both(sv, faces, img, **kw)
        _assert_raster_equal(got, want, name)
        assert bool((got[0] < 1e9).any()), name
    if img == 1024:
        assert got[3].tolist() == [2, 2, 2]


@pytest.mark.cuda
@pytest.mark.parametrize("cull_sign", [-1, 0, 1])
@pytest.mark.parametrize("emit_frags", [False, True])
@pytest.mark.parametrize("n_lin,n_const,z_grads", [(0, 0, False), (0, 0, True), (0, 4, False), (1, 0, False),
                                                   (2, 1, True), (3, 2, False)])
def test_raster_kernel_matches_plain_with_every_flag(cull_sign, emit_frags, n_lin, n_const, z_grads):
    """Every combination of culling, fragments, linear and constant planes
    and depth gradients, on two posed bodies at 128² (two row tiles)."""
    _require_cuda()
    sv, faces = _posed_screen(128, b=2, seed=5)
    attrs = _raster_attrs(faces.shape[0], n_lin, n_const, 6) if n_lin + n_const else None
    got, want = _raster_both(sv, faces, 128, attrs=attrs, n_lin=n_lin, z_grads=z_grads, emit_frags=emit_frags,
                             cull_sign=cull_sign)
    _assert_raster_equal(got, want, "flags")
    assert bool((got[0] < 1e9).any())


def _raster_edge_case(name):
    """(verts_screen, faces, image size, cull_sign) of K4's edge cases."""
    from _torch_cases import coverage_cases, sliver_case

    if name == "slivers":
        return (*sliver_case(256), 256, 0)
    if name in ("whole-image face", "2,000 large boxes", "all culled, and its mirror all kept"):
        return coverage_cases("cuda")[name]
    sv, faces = _posed_screen(256, b=2, seed=9)
    if name == "non-finite vertices":
        sv = sv.clone()
        sv[0, 100:400] = math.nan
        sv[1, 500:520, 2] = math.inf
        sv[1, 700:720, 0] = -math.inf
        return sv.contiguous(), faces, 256, 1
    v = sv.shape[1]
    extra = torch.tensor([[0, 1, v], [-1, 2, 3], [4, v + 7, 5]], dtype=torch.int32, device="cuda")
    return sv, torch.cat([faces, extra]).contiguous(), 256, 0  # index out of range


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["slivers", "whole-image face", "2,000 large boxes",
                                  "all culled, and its mirror all kept", "non-finite vertices",
                                  "index out of range"])
def test_raster_kernel_matches_plain_on_edge_cases(name):
    """Near-degenerate faces (tests/_torch_cases.py::sliver_case), a face over
    the whole image, more large boxes than a block's queue holds, a mesh
    whose faces are all culled, NaN and infinite coordinates, and indices
    out of range (overflow equal to the twin's, counted once per mesh)."""
    _require_cuda()
    sv, faces, img, cull = _raster_edge_case(name)
    attrs = _raster_attrs(faces.shape[0], 1, 1, 7)
    got, want = _raster_both(sv, faces, img, attrs=attrs, n_lin=1, z_grads=True, cull_sign=cull)
    _assert_raster_equal(got, want, name)
    covered = (got[0] < 1e9).flatten(1).sum(1)
    if name.startswith("all culled"):
        assert covered.tolist()[0] == 0 and covered.tolist()[1] > 0
    else:
        assert bool((covered > 0).all())
    assert got[3].tolist() == ([3] * sv.shape[0] if name == "index out of range" else [0] * sv.shape[0])


@pytest.mark.cuda
def test_raster_wrapper_rejects_bad_inputs():
    _require_cuda()
    from humaniflow_torch.render import cuda_raster

    sv, faces = _ragged_screen(64)
    attrs = _raster_attrs(len(faces), 0, 2, 0)
    bad = [
        (sv.double(), faces, None), (sv, faces.long(), None), (sv, faces.cpu(), None), (sv, faces, attrs.double()),
        (sv.transpose(0, 1).contiguous().transpose(0, 1), faces, None), (sv, faces, attrs[:, :3].contiguous()),
        (sv, faces, torch.cat([attrs, attrs, attrs])),
    ]
    for v, f, a in bad:
        with pytest.raises((TypeError, ValueError)):
            cuda_raster.raster(v, f, 64, attrs=a)
    with pytest.raises(ValueError):
        cuda_raster.raster(sv, faces, 64, cull_sign=2)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,v", [(1, 6890), (32, 6890), (72, 6890), (576, 6890), (37, 1000)])
def test_k2_backward_kernel_matches_its_twin(rows, v):
    """(dp, G12) of the backward kernel against the plain per-vertex part,
    with a contiguous cotangent and with the (B, V, 3)-major one that
    smpl_forward's transposed output hands back."""
    _require_cuda()
    args = _kernel_inputs_cuda((rows,), v)
    g = torch.randn((rows, v, 3), generator=torch.Generator("cuda").manual_seed(4), device="cuda")
    for grad in (g.transpose(1, 2).contiguous(), g.transpose(1, 2)):
        before = cuda_lbs.LAUNCHES["smpl_verts_backward"]
        dp, g12 = cuda_lbs.smpl_verts_backward_vertex(grad, True, True, *args)
        torch.cuda.synchronize()
        assert cuda_lbs.LAUNCHES["smpl_verts_backward"] == before + 1
        want_dp, want_g12 = cuda_lbs.smpl_verts_backward_vertex_plain(grad, True, True, *args)
        for got, want in ((dp, want_dp), (g12, want_g12)):
            assert float((got - want).abs().max() / want.abs().max()) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("rows,v", [(1, 6890), (32, 6890), (72, 6890), (576, 6890), (37, 1000)])
def test_k2_backward_on_the_card_matches_autograd_of_the_twin(rows, v):
    """All seven adjoints, one launch of the backward kernel."""
    _require_cuda()
    args = [a.detach().requires_grad_(True) for a in _kernel_inputs_cuda((rows,), v)]
    g = torch.randn((rows, 3, v), generator=torch.Generator("cuda").manual_seed(5), device="cuda")
    before = cuda_lbs.LAUNCHES["smpl_verts"], cuda_lbs.LAUNCHES["smpl_verts_backward"]
    out = cuda_lbs.smpl_verts_differentiable(*args)
    assert cuda_lbs.LAUNCHES["smpl_verts"] == before[0] + 1 and out.grad_fn is not None
    got = torch.autograd.grad(out, args, g)
    assert cuda_lbs.LAUNCHES["smpl_verts_backward"] == before[1] + 1
    want = torch.autograd.grad(cuda_lbs.smpl_verts_plain(*args), args, g)
    for i, (a, w) in enumerate(zip(got, want)):
        assert float((a - w).abs().max() / w.abs().max()) <= 1e-5, i


@pytest.mark.cuda
@pytest.mark.parametrize("needs", [(True, True, True, False, False, False, False), (False, True, False, False, False,
                                   False, False), (True, False, False, False, False, False, True)])
def test_k2_backward_on_the_card_returns_only_what_is_needed(needs):
    _require_cuda()
    args = _kernel_inputs_cuda((8,), 1000)
    g = torch.randn((8, 3, 1000), generator=torch.Generator("cuda").manual_seed(6), device="cuda")
    full = cuda_lbs.smpl_verts_backward(g, [True] * 7, *args)
    part = cuda_lbs.smpl_verts_backward(g, list(needs), *args)
    for i, (need, a, f) in enumerate(zip(needs, part, full)):
        assert (a is None) == (not need), i
        if need:
            assert torch.equal(a, f), i


@pytest.mark.cuda
def test_k2_backward_refuses_tf32_matmuls():
    _require_cuda()
    args = _kernel_inputs_cuda((4,), 256)
    g = torch.ones((4, 3, 256), device="cuda")
    saved = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        with pytest.raises(RuntimeError, match="full float32"):
            cuda_lbs.smpl_verts_backward(g, [True] * 7, *args)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


@pytest.mark.cuda
def test_kernels_without_backward_refuse_inputs_that_require_grad():
    """K1, K2's raw wrapper, K3, K4 and K5 raise instead of returning a result
    with no grad_fn; smpl_forward goes through K2's autograd Function."""
    _require_cuda()
    from humaniflow_torch.flows import cuda_level
    from humaniflow_torch.models import smpl_forward, synthetic_smpl
    from humaniflow_torch.render import cuda_raster

    args = list(_kernel_inputs_cuda((4,), 256))
    grad_betas = [a.requires_grad_(True) if i == 1 else a for i, a in enumerate(args)]
    with pytest.raises(RuntimeError, match="no backward"):
        cuda_lbs.smpl_verts(*grad_betas)
    margs = [a.detach().reshape((2, 2) + a.shape[1:]) if i < 3 else a.detach() for i, a in enumerate(args)]
    margs[0].requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        cuda_lbs.smpl_moments(*margs)
    sv, faces = _ragged_screen(64)
    sv.requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        cuda_coverage.coverage(sv, faces, 64)
    with pytest.raises(RuntimeError, match="no backward"):
        cuda_raster.raster(sv, faces, 64)
    model = _flow_model()
    z, ctx = _level_inputs_cuda(3, 8, 64, seed=0)
    with pytest.raises(RuntimeError, match="no backward"):
        cuda_level.flow_forward_level(model.flow, z, ctx, model.level_parts_0)
    with torch.no_grad():  # the same calls without grad mode run
        cuda_lbs.smpl_verts(*grad_betas)
        cuda_raster.raster(sv, faces, 64)
        cuda_level.flow_forward_level(model.flow, z, ctx, model.level_parts_0)

    smpl = synthetic_smpl(num_verts=6890)
    betas = torch.zeros((2, 10), device="cuda", requires_grad=True)
    eye = torch.eye(3, device="cuda")
    verts = smpl_forward(smpl, betas, eye.expand(2, 23, 3, 3), eye.expand(2, 3, 3))["vertices"]
    assert verts.grad_fn is not None
    verts.sum().backward()
    assert betas.grad is not None and bool(betas.grad.abs().sum() > 0)


def _tiled_ragged(img):
    """Hand-made faces for K6 on two meshes: those of _ragged_screen with a
    finite, in-range vertex index, plus faces with vertices on the culling
    tiles' borders, a square split along its diagonal (pixel centres on the
    shared edge tie), a duplicated face (an exact tie) and a face with a NaN
    depth, padded to one 64-face chunk with copies of the first face; the
    second chunk holds the faces with a NaN x and an ordinary face, and is
    culled everywhere."""
    v, faces = _ragged_screen(img)
    extra = torch.tensor(
        [[128.0, 20.0, 1.0], [140.5, 32.0, 1.0], [128.0, 44.0, 1.0],  # on x = 128 and y = 32
         [40.0, 40.0, 1.0], [80.0, 40.0, 1.0], [80.0, 80.0, 1.0], [40.0, 80.0, 1.0],  # the square
         [20.0, 90.0, math.nan], [60.0, 95.0, 0.5], [30.0, 120.0, 0.5]],  # NaN depth
        device="cuda",
    )
    v = torch.cat([v, torch.stack([extra, extra + torch.tensor([0.0, 0.0, 0.25], device="cuda")])], dim=1)
    n = 18
    more = torch.tensor([[n, n + 1, n + 2], [n + 3, n + 4, n + 5], [n + 3, n + 5, n + 6], [n + 3, n + 5, n + 6],
                         [n + 7, n + 8, n + 9]], dtype=torch.int32, device="cuda")
    nan_x = torch.tensor([5, 11], device="cuda")  # the faces on the NaN-x vertex, both windings
    finite = faces[[i for i in range(faces.shape[0] - 1) if i not in (5, 11)]]
    first = torch.cat([finite, more])
    first = torch.cat([first, first[:1].expand(64 - first.shape[0], 3)])
    return v.contiguous(), torch.cat([first, faces[nan_x], faces[:1]]).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("img", [128, 256, 384])
def test_tiled_raster_kernel_matches_plain_bit_for_bit(img):
    _require_cuda()
    from humaniflow_torch.render import cuda_tiled

    cases = [_tiled_ragged(img)]
    if img == 256:
        sv, faces = _posed_screen(img)
        cases.append((sv, faces[cuda_tiled.tile_sort_order(sv[0], faces)].contiguous()))
    for sv, faces in cases:
        before = cuda_tiled.LAUNCHES["tiled_raster"]
        got = cuda_tiled.rasterize_tiled(sv, faces, img)
        torch.cuda.synchronize()
        assert cuda_tiled.LAUNCHES["tiled_raster"] == before + 1
        want = cuda_tiled.rasterize_tiled_plain(sv, faces, img)
        assert torch.equal(got.face_idx, want.face_idx)
        assert torch.equal(got.depth, want.depth)
        assert torch.equal(got.bary, want.bary)
        assert bool(got.mask.any())


@pytest.mark.cuda
@pytest.mark.parametrize("img", [128, 256, 384])
def test_tiled_raster_kernel_matches_plain_on_slivers(img):
    """tests/_torch_cases.py::sliver_case: 2,400 near-degenerate faces (slivers
    through pixel centres whose rounding claims pixels beyond their tips,
    needles, areas just above 1e-9) on two meshes, bit for bit: the kernel's
    cull skips no face the twin's formula finds inside."""
    _require_cuda()
    from humaniflow_torch.render import cuda_tiled
    from _torch_cases import sliver_case

    sv, faces = sliver_case(img)
    before = cuda_tiled.LAUNCHES["tiled_raster"]
    got = cuda_tiled.rasterize_tiled(sv, faces, img)
    torch.cuda.synchronize()
    assert cuda_tiled.LAUNCHES["tiled_raster"] == before + 1
    want = cuda_tiled.rasterize_tiled_plain(sv, faces, img)
    assert torch.equal(got.face_idx, want.face_idx)
    assert torch.equal(got.depth, want.depth)
    assert torch.equal(got.bary, want.bary)
    assert bool(got.mask.any())


@pytest.mark.cuda
def test_tiled_raster_wrapper_rejects_bad_inputs():
    _require_cuda()
    from humaniflow_torch.render import cuda_tiled

    sv, faces = _tiled_ragged(128)
    for bad_sv, bad_faces, size in ((sv.double(), faces, 128), (sv, faces.long(), 128), (sv, faces.cpu(), 128),
                                    (sv[:, :, :2].contiguous(), faces, 128), (sv, faces, 200), (sv, faces, 96)):
        with pytest.raises((ValueError, TypeError)):
            cuda_tiled.rasterize_tiled(bad_sv, bad_faces, size)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [37, 3200])
def test_lbs_skin_kernel_matches_plain(b):
    _require_cuda()
    g = torch.Generator("cuda").manual_seed(b)
    w = torch.softmax(3.0 * torch.randn((6890, 24), generator=g, device="cuda"), -1)
    a12 = 0.5 * torch.randn((b, 24, 12), generator=g, device="cuda")
    posed = torch.randn((b, 3, 6890), generator=g, device="cuda")
    before = cuda_lbs.LAUNCHES["lbs_skin"]
    got = cuda_lbs.lbs_skin_cm(w, a12, posed)
    torch.cuda.synchronize()
    assert cuda_lbs.LAUNCHES["lbs_skin"] == before + 1
    torch.testing.assert_close(got, cuda_lbs.lbs_skin_cm_plain(w, a12, posed), rtol=0, atol=LBS_ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 37, 65])
@pytest.mark.parametrize("v", [513, 6890, 6891])
def test_lbs_skin_kernel_matches_plain_at_ragged_shapes(b, v):
    """Rows that fill no 4-row chunk or 16-row block whole, and V that fills
    no 512-vertex block whole, even (vertex pairs) and odd."""
    _require_cuda()
    g = torch.Generator("cuda").manual_seed(b + v)
    w = torch.softmax(3.0 * torch.randn((v, 24), generator=g, device="cuda"), -1)
    a12 = 0.5 * torch.randn((b, 24, 12), generator=g, device="cuda")
    posed = torch.randn((b, 3, v), generator=g, device="cuda")
    got = cuda_lbs.lbs_skin_cm(w, a12, posed)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, cuda_lbs.lbs_skin_cm_plain(w, a12, posed), rtol=0, atol=LBS_ATOL)


@pytest.mark.cuda
def test_lbs_skin_gradient_matches_autograd_of_the_twin():
    _require_cuda()
    g = torch.Generator("cuda").manual_seed(5)
    w = torch.softmax(3.0 * torch.randn((6890, 24), generator=g, device="cuda"), -1).requires_grad_(True)
    a12 = (0.5 * torch.randn((72, 24, 12), generator=g, device="cuda")).requires_grad_(True)
    posed = torch.randn((72, 3, 6890), generator=g, device="cuda").requires_grad_(True)
    cot = torch.randn((72, 3, 6890), generator=g, device="cuda")
    out = cuda_lbs.LBSSkin.apply(w, a12, posed)
    got = torch.autograd.grad(out, (w, a12, posed), cot)
    want = torch.autograd.grad(cuda_lbs.lbs_skin_cm_plain(w, a12, posed), (w, a12, posed), cot)
    for a, b in zip(got, want):
        assert float((a - b).abs().max() / b.abs().max()) <= LBS_GRAD_RTOL
    with pytest.raises(RuntimeError, match="no backward"):
        cuda_lbs.lbs_skin_cm(w, a12, posed)
    sv, faces = _tiled_ragged(128)
    from humaniflow_torch.render import cuda_tiled

    with pytest.raises(RuntimeError, match="no backward"):
        cuda_tiled.rasterize_tiled(sv.requires_grad_(True), faces, 128)
