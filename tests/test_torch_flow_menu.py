"""The non-default flow menu against humaniflow_tpu on the CPU: every
transform's forward, inverse and log-det, and the BatchNorm statistics
update.  The whole-model forward under each factory variant is in
tests/test_torch_flow_menu_model.py, a train step with flow BatchNorm in
tests/test_torch_flow_menu_train.py.

The JAX package defines each transform on a single flow, and the port
stacks it over the parts; the references here are the JAX transforms
applied part by part (jax.vmap), which equal the JAX package's stacked flow
wherever that is right (test_stacked_jax_flow_equals_the_per_part_flow; see
tests/_torch_parity.py::PerPartFlow for where it is not)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import PerPartFlow, _reference_humaniflow_state_dict, menu_model_pair, rel_err, t

from humaniflow_torch.flows import create_conditional_norm_flow as torch_flow
from humaniflow_torch.utils.convert_jax import jax_params_to_state_dict
from humaniflow_torch.utils.load_reference import humaniflow_state_from_reference
from humaniflow_tpu.flows.factory import create_conditional_norm_flow as jax_flow
from humaniflow_tpu.utils.convert_torch import convert_humaniflow_checkpoint

# Flow composition: 5e-5 (docs/PARITY.md:37).  BatchNorm statistics and
# outputs: 1e-5.
FLOW_TOL = 5e-5
BN_TOL = 1e-5
CTX = 16
NUM_PARTS = 4
PARTS = (0, 2, 3)

# (name, factory kwargs): one flow block of each transform type and permute type
TRANSFORMS = {
    "additive_coupling": dict(transform_type="additive_coupling", permute_type=None),
    "affine_coupling": dict(transform_type="affine_coupling", permute_type=None),
    "affine_masked": dict(transform_type="affine_masked", permute_type=None),
    "spline_masked": dict(transform_type="spline_masked", permute_type=None),
    "conditional_linear_plu": dict(transform_type="additive_coupling", permute_type="conditional_linear_plu"),
    "linear_plu": dict(transform_type="additive_coupling", permute_type="linear_plu"),
    "batch_norm": dict(transform_type="additive_coupling", permute_type=None, batch_norm=True),
}


def _init_per_part(jt, key, n):
    """A JAX transform's parameters for n parts, stacked on a leading axis."""
    subs = [jt.init(k) for k in jax.random.split(key, n)]
    return jax.tree_util.tree_map(lambda *a: np.stack([np.asarray(x) for x in a]), *subs)


def _randomise_bn(params, rng):
    """Non-trivial BatchNorm parameters (log_gamma, beta, running stats)."""
    for name, (lo, hi) in (("log_gamma", (-0.5, 0.5)), ("beta", (-0.5, 0.5)), ("moving_mean", (-0.5, 0.5)),
                           ("moving_var", (0.5, 2.0))):
        params[name] = rng.uniform(lo, hi, params[name].shape).astype(np.float32)


def _flow_pair(kwargs, seed=0, num_transforms=1):
    """(JAX flow, its parameters stacked over NUM_PARTS parts, port flow
    holding the same weights) of num_transforms flow blocks."""
    kw = dict(event_dim=3, context_dim=CTX, num_transforms=num_transforms, transform_hidden_dims=(32, 32),
              count_bins=4, bound=3.0, **kwargs)
    jflow, tflow = jax_flow(**kw), torch_flow(num_parts=NUM_PARTS, **kw)
    rng = np.random.default_rng(seed)
    jparams = {}
    for i, jt in enumerate(jflow.transforms):
        p = _init_per_part(jt, jax.random.PRNGKey(seed + i), NUM_PARTS)
        if "log_gamma" in p:
            _randomise_bn(p, rng)
        if "LU" in p:  # U's diagonal off ±1, so that the log-det is not 0
            d = np.arange(3)
            p["LU"][:, d, d] *= rng.uniform(0.5, 2.0, (NUM_PARTS, 3)).astype(np.float32)
        if "hypernet" in p or "made" in p:  # larger last layers: the affine clamps and the spline's tails engage
            net = p.get("hypernet", p.get("made"))
            last = net[f"layer_{len(net) - 1}"]
            last["kernel"] = last["kernel"] * 4.0
        jparams[f"transform_{i}"] = p
    tflow.load_state_dict({k[len("flow."):]: v for k, v in jax_params_to_state_dict({"flows": jparams}).items()})
    return jflow, jparams, tflow


def _select(jparams, parts):
    return jax.tree_util.tree_map(lambda a: a[np.asarray(parts)], jparams)


@pytest.mark.parametrize("name", list(TRANSFORMS))
def test_transform_forward_inverse_and_logdet_match_jax(name):
    jflow, jparams, tflow = _flow_pair(TRANSFORMS[name])
    rng = np.random.default_rng(1)
    p = len(PARTS)
    x = rng.normal(scale=1.2, size=(2, 5, p, 3)).astype(np.float32)
    ctx = rng.normal(size=(2, 5, p, CTX)).astype(np.float32)
    sel = _select(jparams, PARTS)
    idx = torch.tensor(PARTS)
    for i, (jt, tt) in enumerate(zip(jflow.transforms, tflow.transforms)):
        pi = sel[f"transform_{i}"]
        jy, jld = jax.vmap(jt.forward, in_axes=(0, -2, -2), out_axes=(-2, -1))(pi, jnp.asarray(x), jnp.asarray(ctx))
        jx, jild = jax.vmap(jt.inverse, in_axes=(0, -2, -2), out_axes=(-2, -1))(pi, jy, jnp.asarray(ctx))
        with torch.no_grad():
            y = tt(t(x), t(ctx), idx)
            back, ld = tt.inverse(t(np.asarray(jy)), t(ctx), idx)
        assert rel_err(y.numpy(), jy) <= FLOW_TOL, (name, i, "forward")
        assert rel_err(back.numpy(), jx) <= FLOW_TOL, (name, i, "inverse")
        assert rel_err(ld.numpy(), jild) <= FLOW_TOL, (name, i, "inverse log-det")
        # the log-det of the inverse at y = f(x) is the forward's at x
        assert rel_err(ld.numpy(), jld) <= FLOW_TOL, (name, i, "forward log-det")
        np.testing.assert_allclose(back.numpy(), x, atol=5e-4)


@pytest.mark.parametrize("name", ["additive_coupling", "affine_coupling", "conditional_linear_plu"])
def test_stacked_jax_flow_equals_the_per_part_flow(name):
    """The reference the port is held to, the JAX flow applied part by
    part, is the JAX model's own stacked flow where that runs right."""
    jflow, jparams, _ = _flow_pair(TRANSFORMS[name])
    rng = np.random.default_rng(2)
    y = jnp.asarray(rng.normal(size=(3, 2, NUM_PARTS, 3)).astype(np.float32))
    ctx = jnp.asarray(rng.normal(size=(3, 2, NUM_PARTS, CTX)).astype(np.float32))
    wrapped = PerPartFlow(jflow)
    np.testing.assert_allclose(np.asarray(wrapped.log_prob(jparams, y, ctx)),
                               np.asarray(jflow.log_prob(jparams, y, ctx)), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(np.asarray(wrapped.forward(jparams, y, ctx)),
                               np.asarray(jflow.forward(jparams, y, ctx)), rtol=1e-6, atol=1e-6)


def test_stacked_jax_batchnorm_sums_its_log_det_over_the_parts():
    """A fault of the reference's stacking, which the port does not copy:
    JAX's FlowBatchNorm reduces its log-det over every axis of its
    parameters, so with a part axis each part's density carries every
    part's BatchNorm log-det."""
    jflow, jparams, _ = _flow_pair(TRANSFORMS["batch_norm"])
    rng = np.random.default_rng(2)
    y = jnp.asarray(rng.normal(size=(3, 2, NUM_PARTS, 3)).astype(np.float32))
    ctx = jnp.asarray(rng.normal(size=(3, 2, NUM_PARTS, CTX)).astype(np.float32))
    bn = jparams["transform_0"]
    ld = np.sum(0.5 * np.log(bn["moving_var"] + 1e-5) - bn["log_gamma"], axis=-1)  # (parts,)
    stacked = np.asarray(jflow.log_prob(jparams, y, ctx))
    per_part = np.asarray(PerPartFlow(jflow).log_prob(jparams, y, ctx))
    np.testing.assert_allclose(stacked - per_part, np.broadcast_to(ld - ld.sum(), stacked.shape), atol=2e-5)
    assert np.abs(ld - ld.sum()).min() > 0.1


def test_batchnorm_update_stats_matches_jax():
    jflow, jparams, tflow = _flow_pair(TRANSFORMS["batch_norm"])
    slot = next(i for i, tt in enumerate(tflow.transforms) if hasattr(tt, "update_stats"))
    jt, tt = jflow.transforms[slot], tflow.transforms[slot]
    y = np.random.default_rng(3).normal(loc=0.7, scale=2.0, size=(16, NUM_PARTS, 3)).astype(np.float32)
    jnew, jx = jt.update_stats(jparams[f"transform_{slot}"], jnp.asarray(y))
    x = tt.update_stats(t(y))
    assert rel_err(x.numpy(), jx) <= BN_TOL
    for k in ("moving_mean", "moving_var"):
        assert rel_err(getattr(tt, k).detach().numpy(), jnew[k]) <= BN_TOL, k
    # the unbiased batch variance, over every leading axis
    np.testing.assert_allclose(tt.moving_var.detach().numpy(),
                               0.9 * jparams[f"transform_{slot}"]["moving_var"] + 0.1 * y.var(0, ddof=1), rtol=1e-5)


def test_flow_update_batchnorm_stats_matches_jax():
    """Two blocks of conditional linear PLU → BatchNorm → affine coupling:
    the density-direction chain feeds each BatchNorm layer its input."""
    jflow, jparams, tflow = _flow_pair(dict(transform_type="affine_coupling", permute_type="conditional_linear_plu",
                                            batch_norm=True, radial_tanh_radius=1.5 * math.pi), num_transforms=2)
    rng = np.random.default_rng(4)
    y = rng.normal(scale=0.8, size=(8, NUM_PARTS, 3)).astype(np.float32)
    ctx = rng.normal(size=(8, NUM_PARTS, CTX)).astype(np.float32)
    jnew = jflow.update_batchnorm_stats(jparams, jnp.asarray(y), jnp.asarray(ctx))
    tflow.update_batchnorm_stats(t(y), t(ctx))
    for slot in (1, 4):
        for k in ("moving_mean", "moving_var"):
            got = getattr(tflow.transforms[slot], k).detach().numpy()
            assert rel_err(got, jnew[f"transform_{slot}"][k]) <= BN_TOL, (slot, k)
            assert not np.allclose(got, jparams[f"transform_{slot}"][k]), (slot, k)


def test_factory_takes_the_permute_hidden_dims():
    flow = torch_flow(event_dim=3, context_dim=CTX, num_transforms=1, num_parts=2,
                      permute_type="conditional_linear_plu", permute_hidden_dims=(7, 5))
    assert [tuple(w.shape[1:]) for w in flow.transforms[0].hypernet.weights] == [(7, CTX), (5, 7), (9, 5)]
    default = torch_flow(event_dim=3, context_dim=CTX, num_transforms=1, num_parts=2,
                         permute_type="conditional_linear_plu")
    assert [tuple(w.shape[1:]) for w in default.transforms[0].hypernet.weights] == [(30, CTX), (30, 30), (9, 30)]


def test_reference_tar_loader_maps_the_menu_as_the_jax_converter():
    """A reference state dict with flow BatchNorm (γ partly negative: pyro
    takes relu(γ) + 1e-6), conditional linear PLU hypernets and affine
    couplings: the port's map equals the JAX converter's."""
    jm, jparams, tm, _, _ = menu_model_pair("affine_coupling", "conditional_linear_plu", True)
    sd = _reference_humaniflow_state_dict(jparams, jm)
    gammas = [k for k in sd if k.endswith(".gamma")]
    assert len(gammas) == 2 * 23
    rng = np.random.default_rng(9)
    for k in gammas:
        sd[k] = torch.from_numpy(rng.uniform(-0.5, 1.5, 3).astype(np.float32))
    want = jax_params_to_state_dict(jax.tree_util.tree_map(np.asarray, convert_humaniflow_checkpoint(
        {k: v.numpy() for k, v in sd.items()}, jm)))
    got = humaniflow_state_from_reference(sd, tm)
    assert sorted(got) == sorted(k for k in tm.state_dict() if not k.endswith("num_batches_tracked"))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=1e-6, atol=0, err_msg=k)
    assert any(float(v.min()) < math.log(1e-5) for k, v in got.items() if k.endswith("log_gamma"))
