"""The fused-flow-level configuration of the port against humaniflow_tpu on
the CPU: `supports_flow`, the level forward of every depth level (the JAX
Pallas kernel in interpret mode and the JAX XLA flow against the port's
plain twin, which is what K5 computes on the card) and the whole model with
the JAX package's switch HFT_FUSED_LEVEL=1, with the same weights and noise.
Then the port's routing rule: a pass takes the fused route exactly when
grad mode is off and `supports_flow` accepts the flow (its structure and
every limit the wrapper enforces), whatever the JAX package's switch reads.
A test that wants the eager flow of a flow K5 takes stands `supports_flow`
in with a refusal."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import IMG, jax_noise, jax_params_from_port, small_cfgs, t
from torch import nn

from humaniflow_torch.flows import cuda_level
from humaniflow_torch.flows.factory import ConditionalFlow
from humaniflow_torch.flows.factory import create_conditional_norm_flow as t_create_flow
from humaniflow_torch.flows.transforms import Permute
from humaniflow_torch.models import HumaniflowModel as TorchModel
from humaniflow_torch.ops import so3_exp
from humaniflow_torch.utils.convert_jax import params_from_jax
from humaniflow_tpu.flows import pallas_level
from humaniflow_tpu.flows.factory import create_conditional_norm_flow as j_create_flow
from humaniflow_tpu.models import HumaniflowModel as JaxModel

# The level forward: 1e-5 abs, the JAX package's own interpret-vs-XLA bound
# (tests/test_pallas_level.py).  The whole model, fused on both sides: 2e-4
# abs, the JAX fused-vs-XLA bound.
LEVEL_ATOL = 1e-5
MODEL_ATOL = 2e-4
B, N = 2, 3


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = small_cfgs()
    jm = JaxModel(jcfg.MODEL)
    source = TorchModel(tcfg.MODEL, device="cpu", generator=torch.Generator().manual_seed(3))
    jparams = jax_params_from_port(source, jm)
    tm = params_from_jax(jparams, TorchModel(tcfg.MODEL, device="cpu"))
    return jm, jparams, tm


def test_supports_default_flow(models):
    jm, _, tm = models
    assert pallas_level.supports_flow(jm.flow)
    assert cuda_level.supports_flow(tm.flow)


@pytest.mark.parametrize(
    "kw",
    [
        {},
        {"radial_tanh_radius": None},
        {"event_dim": 2},
        {"count_bins": 4},
        {"permute_type": None},
        {"transform_hidden_dims": ()},
        {"num_transforms": 3},
    ],
    ids=["default", "no-radius", "event-dim-2", "4-bins", "no-permute", "no-hidden-layer", "3-couplings"],
)
def test_supports_flow_agrees_with_jax(kw):
    args = dict(event_dim=3, context_dim=8, num_transforms=2, radial_tanh_radius=1.5 * np.pi, count_bins=8)
    args.update(kw)
    want = pallas_level.supports_flow(j_create_flow(**args))
    got = cuda_level.supports_flow(t_create_flow(num_parts=2, **args))
    assert got == want


def test_supports_flow_rejects_a_non_spline_coupling():
    """The port has no additive coupling (JAX's own rejected case); a block
    whose second module is no spline coupling is rejected the same way."""
    assert not pallas_level.supports_flow(
        j_create_flow(event_dim=3, context_dim=8, num_transforms=2, transform_type="additive_coupling"))
    flow = ConditionalFlow([Permute((0, 1, 2)), nn.Identity()], event_dim=3, base_dist_std=1.0)
    assert not cuda_level.supports_flow(flow)
    with pytest.raises(ValueError):
        cuda_level.level_params(flow, 8, torch.device("cpu"))


def _level_inputs(p, rows, c, seed):
    """z: mode rows (0), tail rows (±10) and 0.6·N(0, 1) rows; ctx N(0, 1)."""
    rng = np.random.default_rng(seed)
    z = 0.6 * rng.normal(size=(rows, p, 3))
    z[:4] = 0.0
    z[4:8] = 10.0
    z[8:12] = -10.0
    return z.astype(np.float32), rng.normal(size=(rows, p, c)).astype(np.float32)


@pytest.mark.parametrize("level", range(8))
@torch.no_grad()
def test_level_forward_matches_jax(models, level):
    """Every depth level's part count, 300 rows (not a multiple of the TPU
    kernel's 512-row block), with mode and tail rows: the port's twin (what
    K5 computes) against the JAX Pallas kernel in interpret mode and against
    the JAX XLA flow; the ragged 64-row case against the XLA flow."""
    jm, jparams, tm = models
    parts = jm.levels[level]
    p, c = len(parts), jm.cfg.NORM_FLOW.CONTEXT_DIM
    flow_p = jm._part_flow_params(jparams, parts)
    parts_t = torch.tensor(parts)
    for rows, interpret in ((300, True), (64, False)):
        z, ctx = _level_inputs(p, rows, c, seed=10 + level + rows)
        got = cuda_level.flow_forward_level_plain(tm.flow, t(z), t(ctx), parts_t).numpy()
        np.testing.assert_array_equal(cuda_level.flow_forward_level(tm.flow, t(z), t(ctx), parts_t).numpy(), got)
        want_xla = np.asarray(jm.flow.forward(flow_p, jnp.asarray(z), jnp.asarray(ctx)))
        np.testing.assert_allclose(got, want_xla, atol=LEVEL_ATOL, rtol=0, err_msg=f"level {level} vs XLA")
        if interpret:
            packed = pallas_level.pack_level_weights(jm.flow, flow_p)
            want = np.asarray(pallas_level.flow_forward_level(
                jm.flow, packed, jnp.asarray(z), jnp.asarray(ctx), interpret=True))
            np.testing.assert_allclose(got, want, atol=LEVEL_ATOL, rtol=0, err_msg=f"level {level} vs Pallas")
        assert np.abs(got[4:12]).max() < 1.5 * np.pi  # the tails land inside the radial-tanh ball


@torch.no_grad()
def test_level_forward_keeps_leading_shape(models):
    _, _, tm = models
    parts = torch.tensor(tm.levels[2])
    rng = np.random.default_rng(4)
    z = t(rng.normal(size=(3, 7, len(parts), 3)).astype(np.float32))
    ctx = t(rng.normal(size=(3, 7, len(parts), 64)).astype(np.float32))
    out = cuda_level.flow_forward_level(tm.flow, z, ctx, parts)
    assert out.shape == (3, 7, len(parts), 3)
    flat = cuda_level.flow_forward_level(tm.flow, z.reshape(21, len(parts), 3), ctx.reshape(21, len(parts), 64), parts)
    np.testing.assert_array_equal(out.reshape(21, len(parts), 3).numpy(), flat.numpy())


def test_level_params_rejects_widths_the_kernel_does_not_hold():
    cpu = torch.device("cpu")
    wide = t_create_flow(event_dim=3, context_dim=8, num_transforms=2, num_parts=2,
                         transform_hidden_dims=(256,), radial_tanh_radius=3.0)
    with pytest.raises(ValueError, match="hidden widths"):
        cuda_level.level_params(wide, 8, cpu)
    ok = t_create_flow(event_dim=3, context_dim=8, num_transforms=2, num_parts=2, radial_tanh_radius=3.0)
    with pytest.raises(ValueError, match="context"):
        cuda_level.level_params(ok, 16, cpu)
    prm = cuda_level.level_params(ok, 8, cpu)
    assert prm.n_couplings == 2 and list(prm.perm[1]) == [1, 2, 0] and prm.max_tiles == 8
    # each layer packed as mma fragments (k-steps × n-tiles × 64 floats) and its bias by column, the first
    # layer also x0's column: 8 contexts in 2 k-steps, then 64, 32, 32 and 62→64 outputs
    assert list(prm.k_steps[0][:4]) == [2, 8, 4, 4] and list(prm.n_tiles[0][:4]) == [8, 4, 4, 8]
    assert prm.coupling_floats == (2 * 8 * 64 + 64 + 64) + (8 * 4 * 64 + 32) + (4 * 4 * 64 + 32) + (4 * 8 * 64 + 64)


def test_autoregress_routes_each_level_through_the_wrapper(models, monkeypatch):
    """With supports_flow accepting the flow, _autoregress calls
    flow_forward_level once per level (on the CPU it computes the twin and
    counts no launch); with it refusing, never.  The rule is read on every
    call."""
    _, _, tm = models
    calls = _spy_on_the_wrapper(monkeypatch)
    isgc = torch.randn((2, 4, tm.isgc_dim), generator=torch.Generator().manual_seed(0))
    before = cuda_level.LAUNCHES["flow_level"]
    with torch.no_grad():
        on = tm._autoregress(isgc)
        assert calls == list(tm.levels)
        _refuse_k5(monkeypatch)
        off = tm._autoregress(isgc)
    assert len(calls) == len(tm.levels) and cuda_level.LAUNCHES["flow_level"] == before
    for a, b in zip(on, off):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_fused_model_matches_jax_fused_model(models, monkeypatch):
    """apply(num_samples=3), the JAX side with its switch HFT_FUSED_LEVEL=1
    and the port on its default route (grad off): the port's twin against
    the JAX Pallas kernel in interpret mode, same weights and the JAX
    model's own noise."""
    jm, jparams, tm = models
    proxy = np.random.default_rng(11).normal(size=(B, IMG, IMG, 18)).astype(np.float32)
    key = jax.random.PRNGKey(12)
    shape_noise, levels = jax_noise(jm, key, B, N)
    monkeypatch.setenv("HFT_FUSED_LEVEL", "1")
    assert jm._fused_level_enabled()
    want = jax.device_get(jm.apply(jparams, jnp.asarray(proxy), key=key, num_samples=N))
    with torch.inference_mode():
        assert tm._fused_level_enabled()
        got = tm.apply(t(proxy), num_samples=N, base_noise=[t(z) for z in levels], shape_noise=t(shape_noise))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=MODEL_ATOL, rtol=0, err_msg=k)


@pytest.fixture(scope="module")
def port_models():
    """A default-flow and a menu-flow (additive coupling, which K5 refuses)
    port model on the small config, seeded."""
    _, tcfg = small_cfgs()
    nf = dataclasses.replace(tcfg.MODEL.NORM_FLOW, TRANSFORM_TYPE="additive_coupling", PERMUTE_TYPE="permute")
    menu = dataclasses.replace(tcfg.MODEL, NORM_FLOW=nf)
    return {"default": TorchModel(tcfg.MODEL, device="cpu", generator=torch.Generator().manual_seed(5)),
            "menu": TorchModel(menu, device="cpu", generator=torch.Generator().manual_seed(6))}


def _spy_on_the_wrapper(monkeypatch):
    calls = []
    real = cuda_level.flow_forward_level

    def spy(flow, z, ctx, parts):
        calls.append(tuple(parts.tolist()))
        return real(flow, z, ctx, parts)

    monkeypatch.setattr(cuda_level, "flow_forward_level", spy)
    return calls


def _refuse_k5(monkeypatch):
    """The eager flow for every model from here on: supports_flow refuses."""
    monkeypatch.setattr(cuda_level, "supports_flow", lambda flow: False)


def _set_switch(monkeypatch, switch):
    if switch is None:
        monkeypatch.delenv("HFT_FUSED_LEVEL", raising=False)
    else:
        monkeypatch.setenv("HFT_FUSED_LEVEL", switch)


@pytest.mark.parametrize("flow", ["default", "menu"])
@pytest.mark.parametrize("grad", [False, True], ids=["no-grad", "grad"])
@pytest.mark.parametrize("switch", [None, "0", "1"], ids=["unset", "0", "1"])
def test_routing_rule(port_models, monkeypatch, switch, grad, flow):
    """_autoregress calls flow_forward_level once per level exactly where
    the rule routes the pass to K5, and never elsewhere: when grad mode is
    off and supports_flow accepts the flow.  The port ignores the JAX
    package's HFT_FUSED_LEVEL: unset, 0 and 1 route alike."""
    tm = port_models[flow]
    assert cuda_level.supports_flow(tm.flow) == (flow == "default")
    calls = _spy_on_the_wrapper(monkeypatch)
    _set_switch(monkeypatch, switch)
    isgc = torch.randn((2, 3, tm.isgc_dim), generator=torch.Generator().manual_seed(1))
    noise = tm._draw_level_noise((2, 3), torch.Generator().manual_seed(2))
    fused = flow == "default" and not grad
    with torch.set_grad_enabled(grad):
        assert tm._fused_level_enabled() == fused
        so3, rot = tm._autoregress(isgc, noise)
    assert calls == (list(tm.levels) if fused else [])
    assert so3.shape == (2, 3, 23, 3) and bool(torch.isfinite(rot).all())


# Flows of the kind K5 is specialised to whose counts or widths it does not
# hold: every limit of the wrapper, each as the model's config sets it.
_BEYOND_K5 = {
    "hidden-256": dict(TRANSFORM_NN_HIDDEN_DIMS=(256, 128)),
    "context-256": dict(CONTEXT_DIM=256),
    "9-layers": dict(TRANSFORM_NN_HIDDEN_DIMS=(16,) * 8),
    "9-couplings": dict(NUM_TRANSFORMS=9),
    "shared-memory": dict(TRANSFORM_NN_HIDDEN_DIMS=(128, 128, 128)),
}


@pytest.mark.parametrize("case", list(_BEYOND_K5))
def test_a_flow_beyond_k5s_limits_routes_eager(monkeypatch, case):
    """A default-kind flow that the wrapper would refuse (level_params or
    the shared-memory check raise) is one supports_flow refuses too, so
    under inference_mode the pass runs eager."""
    _, tcfg = small_cfgs()
    nf = dataclasses.replace(tcfg.MODEL.NORM_FLOW, **_BEYOND_K5[case])
    tm = TorchModel(dataclasses.replace(tcfg.MODEL, NORM_FLOW=nf), device="cpu",
                    generator=torch.Generator().manual_seed(7))
    assert cuda_level._matches_kernel(tm.flow) and not cuda_level.supports_flow(tm.flow)
    with pytest.raises(ValueError):
        cuda_level.level_params(tm.flow, nf.CONTEXT_DIM, torch.device("cpu"))
    calls = _spy_on_the_wrapper(monkeypatch)
    isgc = torch.randn((2, 3, tm.isgc_dim), generator=torch.Generator().manual_seed(8))
    with torch.inference_mode():
        assert not tm._fused_level_enabled()
        _, rot = tm._autoregress(isgc, tm._draw_level_noise((2, 3), torch.Generator().manual_seed(9)))
    assert calls == [] and bool(torch.isfinite(rot).all())


@pytest.mark.parametrize("c_dim, hidden", [(8, (64, 32, 32)), (64, (64, 32, 32)), (100, (128, 7)), (128, (16,) * 7),
                                           (5, (100,))])
def test_layout_is_the_packs_layout(c_dim, hidden):
    """_layout's per-layer floats (which size the kernel's shared memory and
    offsets) are the blocks level_pack gathers, coupling by coupling."""
    flow = t_create_flow(event_dim=3, context_dim=c_dim, num_transforms=2, num_parts=3,
                         transform_hidden_dims=hidden, radial_tanh_radius=3.0)
    couplings, floats = cuda_level._layout(flow, c_dim)
    sizes = [layers[-1][0] + layers[-1][1] for _, layers in couplings]
    assert floats == max(sizes)
    for (dims, _), size in zip(couplings, sizes):
        assert len(cuda_level._coupling_index(dims, c_dim)) == size
    assert cuda_level.level_pack(flow, c_dim).shape == (3, 2, floats)


def test_train_forward_with_the_switch_unset_runs_eager(port_models, monkeypatch):
    """The train step's forward (grad on, train=True, the teacher-forced
    contexts, samples) of a flow K5 takes: the eager flow, no error, and a
    gradient that reaches the flow's weights."""
    tm = TorchModel(port_models["default"].cfg, device="cpu")
    tm.load_state_dict(port_models["default"].state_dict())
    calls = _spy_on_the_wrapper(monkeypatch)
    g = torch.Generator().manual_seed(3)
    proxy = torch.rand((2, IMG, IMG, 18), generator=g)
    pose = so3_exp(0.3 * torch.randn((2, 23, 3), generator=g))
    glob = so3_exp(0.3 * torch.randn((2, 3), generator=g))
    shape = torch.randn((2, 10), generator=g)
    out = tm.apply(proxy, generator=g, num_samples=2, compute_for_loglik=True, shape_for_loglik=shape,
                   pose_R_for_loglik=pose, glob_R_for_loglik=glob, train=True, grad_for_pose_point_est=True)
    assert calls == []
    loss = out["pose_rotmats_samples"].sum() + tm.pose_log_prob(pose, out["pose_flow_contexts_for_loglik"]).sum()
    loss.backward()
    hyper = tm.flow.transforms[1].hypernet.weights[0]
    assert hyper.grad is not None and float(hyper.grad.abs().sum()) > 0


def test_inference_default_route_is_the_eager_result_on_the_cpu(port_models, monkeypatch):
    """Under inference_mode the default route (the fused one, whose CPU twin
    is the flow's own call) gives every output bit for bit as the eager
    flow, which a refusing supports_flow forces."""
    tm = port_models["default"]
    calls = _spy_on_the_wrapper(monkeypatch)
    proxy = torch.rand((2, IMG, IMG, 18), generator=torch.Generator().manual_seed(4))
    outs = {}
    for route in ("default", "eager"):
        if route == "eager":
            _refuse_k5(monkeypatch)
        with torch.inference_mode():
            outs[route] = tm.apply(proxy, generator=torch.Generator().manual_seed(5), num_samples=3)
    assert calls == list(tm.levels)
    assert set(outs["default"]) == set(outs["eager"])
    for k, v in outs["eager"].items():
        assert torch.equal(outs["default"][k], v), k
