"""humaniflow_torch SO(3) ops, rotations and flows against humaniflow_tpu,
on the CPU, on the same numpy inputs."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import rel_err, t
from scipy.spatial.transform import Rotation

from humaniflow_torch import ops as tops
from humaniflow_torch.flows import create_conditional_norm_flow as torch_flow
from humaniflow_torch.flows import spline as tspline
from humaniflow_tpu.flows import spline as jspline
from humaniflow_tpu.flows.factory import create_conditional_norm_flow as jax_flow
from humaniflow_tpu.ops import rotation as jrot
from humaniflow_tpu.ops import so3 as jso3

# SO(3) maps agree to 1e-6 absolute: the same float32 formulas, differing only
# in the last bits of each framework's sin/cos/arccos.
SO3_ATOL = 1e-6
# Flow forward: 5e-5 relative (a few hundred float32 ops per element).
FLOW_RTOL = 5e-5


def _axis_angles(kind: str, n: int = 64) -> np.ndarray:
    rng = np.random.default_rng({"zero": 0, "pi": 1, "random": 2}[kind])
    axes = rng.normal(size=(n, 3))
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    if kind == "zero":
        angles = np.concatenate([np.zeros(4), 10.0 ** rng.uniform(-9, -3, n - 4)])
    elif kind == "pi":
        angles = math.pi - np.concatenate([np.zeros(4), 10.0 ** rng.uniform(-7, -1.2, n - 4)])
    else:
        angles = rng.uniform(0.0, math.pi, n)
    return (axes * angles[:, None]).astype(np.float32)


@pytest.mark.parametrize("kind", ["zero", "pi", "random"])
def test_so3_exp_matches_jax(kind):
    v = _axis_angles(kind)
    np.testing.assert_allclose(
        tops.so3_exp(t(v)).numpy(), np.asarray(jso3.so3_exp(jnp.asarray(v))), atol=SO3_ATOL, rtol=0
    )


@pytest.mark.parametrize("kind", ["zero", "pi", "random"])
def test_so3_log_matches_jax(kind):
    r = Rotation.from_rotvec(_axis_angles(kind).astype(np.float64)).as_matrix().astype(np.float32)
    got = tops.so3_log(t(r)).numpy()
    want = np.asarray(jso3.so3_log(jnp.asarray(r)))
    np.testing.assert_allclose(got, want, atol=SO3_ATOL, rtol=0)


@pytest.mark.parametrize("kind", ["zero", "pi", "random"])
def test_so3_helpers_match_jax(kind):
    v = _axis_angles(kind)
    theta = np.linalg.norm(v, axis=-1)
    pairs = [
        (tops.sinc(t(theta)), jso3.sinc(jnp.asarray(theta))),
        (tops.so3_hat(t(v)), jso3.so3_hat(jnp.asarray(v))),
        (tops.so3_vee(tops.so3_hat(t(v))), jso3.so3_vee(jso3.so3_hat(jnp.asarray(v)))),
        (tops.so3_xset(t(v), k_max=2), jso3.so3_xset(jnp.asarray(v), k_max=2)),
        (tops.so3_log_abs_det_jacobian(t(v)), jso3.so3_log_abs_det_jacobian(jnp.asarray(v))),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=SO3_ATOL, rtol=0)


def test_rotation_conversions_match_jax():
    rng = np.random.default_rng(3)
    x6 = rng.normal(size=(32, 6)).astype(np.float32)
    r = np.asarray(jrot.rot6d_to_rotmat(jnp.asarray(x6)))
    np.testing.assert_allclose(tops.rot6d_to_rotmat(t(x6)).numpy(), r, atol=SO3_ATOL, rtol=0)
    for stack in (False, True):
        np.testing.assert_array_equal(
            tops.rotmat_to_rot6d(t(r), stack_columns=stack).numpy(),
            np.asarray(jrot.rotmat_to_rot6d(jnp.asarray(r), stack_columns=stack)),
        )
    v = _axis_angles("random")
    np.testing.assert_allclose(
        tops.batch_rodrigues(t(v)).numpy(), np.asarray(jrot.batch_rodrigues(jnp.asarray(v))),
        atol=SO3_ATOL, rtol=0,
    )


def _spline_inputs(seed=4, shape=(64, 2), k=8, bound=3.0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.3 * bound, 1.3 * bound, size=shape).astype(np.float32)
    w, h, l = (rng.normal(size=shape + (k,)).astype(np.float32) for _ in range(3))
    d = rng.normal(size=shape + (k - 1,)).astype(np.float32)
    return x, w, h, d, l


def test_spline_forward_matches_jax():
    args = _spline_inputs()
    y = tspline.monotonic_rational_spline_forward(*map(t, args), bound=3.0)
    jy, _ = jspline.monotonic_rational_spline(*map(jnp.asarray, args), bound=3.0)
    assert rel_err(y.numpy(), jy) < FLOW_RTOL


def test_spline_bin_search_ties_match_jax():
    """At a knot (x == knot + EPS exactly) both pick the bin the knot opens."""
    _, w, _, _, _ = _spline_inputs()
    _, knots = tspline._make_knots(t(w), 3.0, tspline.MIN_BIN_WIDTH)
    x = (knots + tspline.EPS).numpy()[..., 1:-1].reshape(-1)
    knots_np = np.repeat(knots.numpy().reshape(-1, 1, 9), 7, axis=1).reshape(-1, 9)
    got = tspline._search_bins(t(knots_np), t(x))[..., 0].numpy()
    want = np.asarray(jnp.argmax(jspline._search_bins_onehot(jnp.asarray(knots_np), jnp.asarray(x)), -1))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.tile(np.arange(1, 8), len(got) // 7))


@pytest.mark.parametrize("parts", [(0, 1, 2), (4,)])
def test_flow_forward_matches_jax(parts):
    """Default flow (permute → spline coupling ×2 → radial tanh), 5 stacked
    parts, evaluated for a subset of them on (B, N, P) inputs."""
    num_parts, radius = 5, 1.5 * math.pi
    kw = dict(event_dim=3, context_dim=64, num_transforms=2, radial_tanh_radius=radius,
              base_dist_std=0.6, count_bins=8, bound=radius)
    jflow = jax_flow(**kw)
    tflow = torch_flow(num_parts=num_parts, **kw)
    keys = jax.random.split(jax.random.PRNGKey(5), num_parts)
    jparams = jax.vmap(jflow.init)(keys)
    state = {}
    for i in (1, 3):
        for k in range(4):
            layer = jparams[f"transform_{i}"]["hypernet"][f"layer_{k}"]
            state[f"transforms.{i}.hypernet.weights.{k}"] = t(np.asarray(layer["kernel"]).transpose(0, 2, 1))
            state[f"transforms.{i}.hypernet.biases.{k}"] = t(layer["bias"])
    tflow.load_state_dict(state)

    rng = np.random.default_rng(6)
    p = len(parts)
    z = rng.normal(scale=1.5, size=(2, 3, p, 3)).astype(np.float32)
    ctx = rng.normal(size=(2, 3, p, 64)).astype(np.float32)
    sel = jax.tree_util.tree_map(lambda a: a[np.asarray(parts)], jparams)
    want = np.asarray(jflow.forward(sel, jnp.asarray(z), jnp.asarray(ctx)))
    with torch.no_grad():
        got = tflow(t(z), t(ctx), torch.tensor(parts)).numpy()
        mode = tflow(torch.zeros_like(t(z)), t(ctx), torch.tensor(parts)).numpy()
    assert rel_err(got, want) < FLOW_RTOL
    assert rel_err(mode, np.asarray(jflow.mode_estimate(sel, jnp.asarray(ctx)))) < FLOW_RTOL


@pytest.mark.parametrize(
    "kwargs", [dict(transform_type="planar"), dict(permute_type="householder"),
               dict(transform_type="affine_coupling", permute_type="reverse", batch_norm=True)]
)
def test_flow_factory_rejects_unported_transforms(kwargs):
    """The whole JAX menu is ported (tests/test_torch_flow_menu.py); what it
    does not offer, neither factory builds."""
    with pytest.raises(ValueError):
        torch_flow(event_dim=3, context_dim=8, num_transforms=1, num_parts=1, **kwargs)
    with pytest.raises((ValueError, AssertionError)):
        jax_flow(event_dim=3, context_dim=8, num_transforms=1, **kwargs)
