"""The fused-flow-level configuration of the port against humaniflow_tpu on
the CPU: `supports_flow`, the level forward of every depth level (the JAX
Pallas kernel in interpret mode and the JAX XLA flow against the port's
plain twin, which is what K5 computes on the card) and the whole model with
HFT_FUSED_LEVEL=1 on both sides, with the same weights and noise."""

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
    assert prm.n_couplings == 2 and list(prm.perm[1]) == [1, 2, 0] and prm.act_rows == 64
    # coupling weights padded to (8k outputs, 4k inputs): 9→12 inputs, 64, 32, 32, 62→64 outputs
    assert prm.weight_floats == 64 * 12 + 64 + 32 * 64 + 32 + 32 * 32 + 32 + 64 * 32 + 64


def test_autoregress_routes_each_level_through_the_wrapper(models, monkeypatch):
    """With the switch on, _autoregress calls flow_forward_level once per
    level (on the CPU it computes the twin and counts no launch); with the
    switch off, never.  The switch is read on every call."""
    _, _, tm = models
    calls = []
    real = cuda_level.flow_forward_level

    def spy(flow, z, ctx, parts):
        calls.append(tuple(parts.tolist()))
        return real(flow, z, ctx, parts)

    monkeypatch.setattr(cuda_level, "flow_forward_level", spy)
    isgc = torch.randn((2, 4, tm.isgc_dim), generator=torch.Generator().manual_seed(0))
    before = cuda_level.LAUNCHES["flow_level"]
    with torch.no_grad():
        monkeypatch.setenv("HFT_FUSED_LEVEL", "1")
        on = tm._autoregress(isgc)
        assert calls == list(tm.levels)
        monkeypatch.setenv("HFT_FUSED_LEVEL", "0")
        off = tm._autoregress(isgc)
    assert len(calls) == len(tm.levels) and cuda_level.LAUNCHES["flow_level"] == before
    for a, b in zip(on, off):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_fused_model_matches_jax_fused_model(models, monkeypatch):
    """apply(num_samples=3) with HFT_FUSED_LEVEL=1 on both sides: the port's
    twin against the JAX Pallas kernel in interpret mode, same weights and
    the JAX model's own noise."""
    jm, jparams, tm = models
    proxy = np.random.default_rng(11).normal(size=(B, IMG, IMG, 18)).astype(np.float32)
    key = jax.random.PRNGKey(12)
    shape_noise, levels = jax_noise(jm, key, B, N)
    monkeypatch.setenv("HFT_FUSED_LEVEL", "1")
    assert tm._fused_level_enabled() and jm._fused_level_enabled()
    want = jax.device_get(jm.apply(jparams, jnp.asarray(proxy), key=key, num_samples=N))
    with torch.inference_mode():
        got = tm.apply(t(proxy), num_samples=N, base_noise=[t(z) for z in levels], shape_noise=t(shape_noise))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=MODEL_ATOL, rtol=0, err_msg=k)
