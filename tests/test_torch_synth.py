"""The port's synthetic-data generation against humaniflow_tpu on the CPU:
each augmentation with the numbers JAX drew, the crop jitter, the joint and
label helpers, and the whole `make_synth_data_fn` batch on the exact render
path.

JAX draws from PRNG keys, the port from one `Draws` source.  The tests run
the JAX function with jax.random.normal / uniform / randint wrapped to
record what they return (under jax.disable_jit(), so the values are
concrete), then hand the port a source that returns those numbers in the
same order.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import IMG, t

import humaniflow_tpu.data.augmentation as jaug
from humaniflow_torch.configs import get_humaniflow_cfg_defaults as torch_defaults
from humaniflow_torch.configs.defaults import ProxyRepAugment, RgbAugment
from humaniflow_torch.data import augmentation as taug
from humaniflow_torch.data import image_ops as timg
from humaniflow_torch.data import joints2d_utils as tj2d
from humaniflow_torch.data import label_conversions as tlab
from humaniflow_torch.models import smpl as tsmpl
from humaniflow_torch.pipelines import make_synth_data_fn as torch_synth
from humaniflow_torch.render import TexturedIUVRenderer as TorchRenderer
from humaniflow_tpu.configs import get_humaniflow_cfg_defaults as jax_defaults
from humaniflow_tpu.configs.defaults import ProxyRepAugment as JProxyRepAugment
from humaniflow_tpu.configs.defaults import RgbAugment as JRgbAugment
from humaniflow_tpu.data import image_ops as jimg
from humaniflow_tpu.data import joints2d_utils as jj2d
from humaniflow_tpu.data import label_conversions as jlab
from humaniflow_tpu.models import smpl as jsmpl
from humaniflow_tpu.pipelines.train import make_synth_data_fn as jax_synth
from humaniflow_tpu.render import TexturedIUVRenderer as JaxRenderer

# Pixel coordinates (joints, boxes) within 1e-4 px; images within 1e-5, or
# on ≥ 99.9% of the pixels where a pixel centre on a face edge can change
# the winning face; Canny edges on ≥ 99.9% of the pixels (the arctan2 tie
# of ROADMAP.md §3).
PX_ATOL = 1e-4
IMG_ATOL = 1e-5
PIXEL_FRAC = 0.999
B = 2


class ReplayDraws:
    """A Draws source that returns recorded numbers in order."""

    def __init__(self, recorded):
        self.recorded = list(recorded)

    def _next(self, shape):
        a = self.recorded.pop(0)
        assert a.shape == tuple(shape), (a.shape, tuple(shape))
        return torch.from_numpy(np.array(a))

    def normal(self, shape):
        return self._next(shape)

    def uniform(self, shape, lo=0.0, hi=1.0):
        return self._next(shape)

    def randint(self, shape, lo, hi):
        return self._next(shape).to(torch.int64)

    def whole(self):
        return self


@pytest.fixture
def record(monkeypatch):
    """The numbers jax.random.normal / uniform / randint return, in call order."""
    out = []
    for name in ("normal", "uniform", "randint"):
        orig = getattr(jax.random, name)

        def wrapped(*args, _orig=orig, **kw):
            value = _orig(*args, **kw)
            out.append(np.asarray(value))
            return value

        monkeypatch.setattr(jax.random, name, wrapped)
    return out


def _replay(record):
    draws = ReplayDraws(record)
    record.clear()
    return draws


def _seg(seed, b=B, img=IMG):
    """DensePose part labels 0..24 in blobs, and joints on and off the image."""
    rng = np.random.default_rng(seed)
    seg = np.zeros((b, img, img), np.int32)
    for i in range(b):
        for _ in range(30):
            r, c, s = rng.integers(0, img, 2).tolist() + [int(rng.integers(3, 12))]
            seg[i, r:r + s, c:c + s] = rng.integers(1, 25)
    joints = rng.uniform(-0.1 * img, 1.1 * img, size=(b, 17, 2)).astype(np.float32)
    vis = rng.uniform(size=(b, 17)) > 0.2
    return seg, joints, vis


def _likely(cfg, prob=0.5):
    """cfg with every probability set to prob, so that every branch fires."""
    changes = {f.name: prob for f in dataclasses.fields(cfg) if f.name.endswith("_PROB")}
    if hasattr(cfg, "REMOVE_PARTS_PROBS"):
        changes["REMOVE_PARTS_PROBS"] = (prob,) * len(cfg.REMOVE_PARTS_PROBS)
    return dataclasses.replace(cfg, **changes)


def test_sampling_augmentations_match_jax(record):
    key = jax.random.PRNGKey(0)
    with jax.disable_jit():
        want = [
            jaug.normal_sample_shape(key, 5, jnp.zeros(10), jnp.full((10,), 1.25)),
            jaug.uniform_sample_shape(key, 5, jnp.ones(10), (-0.5, 1.5)),
            jaug.augment_cam_t(key, jnp.tile(jnp.asarray([[0.0, -0.2, 2.5]]), (5, 1)), 0.05, (-0.5, 0.5)),
            jaug.augment_light_t(key, 5, (0.05, 3.0)),
            *jaug.augment_light_colour(key, 5, (0.4, 0.8), (0.4, 0.8), (0.0, 0.5)).values(),
        ]
    draws = _replay(record)
    got = [
        taug.normal_sample_shape(draws, 5, torch.zeros(10), torch.full((10,), 1.25)),
        taug.uniform_sample_shape(draws, 5, torch.ones(10), (-0.5, 1.5)),
        taug.augment_cam_t(draws, torch.tensor([[0.0, -0.2, 2.5]]).repeat(5, 1), 0.05, (-0.5, 0.5)),
        taug.augment_light_t(draws, 5, (0.05, 3.0)),
        *taug.augment_light_colour(draws, 5, (0.4, 0.8), (0.4, 0.8), (0.0, 0.5)).values(),
    ]
    assert not draws.recorded
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("prob", [0.0, 0.5, 1.0])
def test_proxy_augmentation_matches_jax(record, prob):
    seg, joints, vis = _seg(1)
    key = jax.random.PRNGKey(1)
    with jax.disable_jit():
        want = jaug.augment_proxy_representation(key, jnp.asarray(seg), jnp.asarray(joints), jnp.asarray(vis),
                                                 _likely(JProxyRepAugment(), prob))
        want_crop = jaug.random_extreme_crop(key, jnp.asarray(seg), 0.5 * prob)
    draws = _replay(record)
    got = taug.augment_proxy_representation(draws, t(seg), t(joints), t(vis), _likely(ProxyRepAugment(), prob))
    got_crop = taug.random_extreme_crop(draws, t(seg), 0.5 * prob)
    assert not draws.recorded
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=0, atol=PX_ATOL)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(got_crop.numpy(), np.asarray(want_crop))
    if prob == 1.0:
        assert int((got[0] == 0).sum()) > int((t(seg) == 0).sum())


@pytest.mark.parametrize("prob", [0.0, 1.0])
def test_rgb_augmentation_matches_jax(record, prob):
    rng = np.random.default_rng(2)
    rgb = rng.uniform(size=(B, IMG, IMG, 3)).astype(np.float32)
    _, joints, vis = _seg(3)
    with jax.disable_jit():
        want = jaug.augment_rgb(jax.random.PRNGKey(2), jnp.asarray(rgb), jnp.asarray(joints), jnp.asarray(vis),
                                _likely(JRgbAugment(), prob))
    draws = _replay(record)
    got = taug.augment_rgb(draws, t(rgb), t(joints), t(vis), _likely(RgbAugment(), prob))
    assert not draws.recorded
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


def test_crop_jitter_background_and_labels_match_jax(record):
    rng = np.random.default_rng(4)
    seg, joints, vis = _seg(5)
    iuv = np.stack([seg.astype(np.float32), rng.uniform(size=seg.shape), rng.uniform(size=seg.shape)], -1)
    iuv = iuv.astype(np.float32)
    rgb = rng.uniform(size=(B, IMG, IMG, 3)).astype(np.float32)
    bg = rng.uniform(size=(B, IMG, IMG, 3)).astype(np.float32)
    kw = dict(orig_scale_factor=1.2, delta_scale_range=(-0.3, 0.2), delta_centre_range=(-5, 5),
              out_of_frame_pad_val=-1.0)
    with jax.disable_jit():
        want = jimg.batch_crop_affine((IMG, IMG), iuv=jnp.asarray(iuv), rgb=jnp.asarray(rgb),
                                      joints2d=jnp.asarray(joints), bbox_determiner=jnp.asarray(seg, jnp.float32),
                                      key=jax.random.PRNGKey(6), **kw)
    draws = _replay(record)
    got = timg.batch_crop_affine((IMG, IMG), iuv=t(iuv), rgb=t(rgb), joints2d=t(joints),
                                 bbox_determiner=t(seg).float(), draws=draws, **kw)
    assert not draws.recorded
    for k in ("crop_scale", "crop_trans", "joints2d"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6, atol=PX_ATOL, err_msg=k)
    np.testing.assert_allclose(got["iuv"].numpy(), np.asarray(want["iuv"]), rtol=0, atol=IMG_ATOL)
    np.testing.assert_allclose(got["rgb"].numpy(), np.asarray(want["rgb"]), rtol=0, atol=IMG_ATOL)
    assert float(got["iuv"].min()) == -1.0  # the jitter moves the box past the image edge

    np.testing.assert_array_equal(timg.batch_add_rgb_background(t(bg), t(rgb), t(seg)).numpy(),
                                  np.asarray(jimg.batch_add_rgb_background(jnp.asarray(bg), jnp.asarray(rgb),
                                                                           jnp.asarray(seg))))
    seg14 = tlab.convert_densepose_seg_to_14part_labels(t(seg))
    np.testing.assert_array_equal(seg14.numpy(), np.asarray(jlab.convert_densepose_seg_to_14part_labels(
        jnp.asarray(seg))))
    vis_in = tj2d.check_joints2d_visibility(t(joints), IMG, t(vis))
    np.testing.assert_array_equal(vis_in.numpy(), np.asarray(jj2d.check_joints2d_visibility(
        jnp.asarray(joints), IMG, jnp.asarray(vis))))
    for threshold in (0, 50):
        np.testing.assert_array_equal(
            tj2d.check_joints2d_occluded(seg14, vis_in, threshold).numpy(),
            np.asarray(jj2d.check_joints2d_occluded(jnp.asarray(seg14.numpy()), jnp.asarray(vis_in.numpy()),
                                                    threshold)))


def _collapsed(cfg):
    """The training config at IMG² with every augmentation range collapsed
    and every augmentation probability 0."""
    aug = cfg.TRAIN.SYNTH_DATA.AUGMENT
    zero = lambda c: dataclasses.replace(c, **{f.name: 0.0 for f in dataclasses.fields(c)  # noqa: E731
                                                if f.name.endswith("_PROB")})
    proxy = zero(aug.PROXY_REP)
    proxy = dataclasses.replace(proxy, REMOVE_PARTS_PROBS=(0.0,) * len(proxy.REMOVE_PARTS_PROBS),
                                DELTA_J2D_DEV_RANGE=(0.0, 0.0))
    rgb = dataclasses.replace(zero(aug.RGB), LIGHT_LOC_RANGE=(2.0, 2.0), LIGHT_AMBIENT_RANGE=(0.6, 0.6),
                              LIGHT_DIFFUSE_RANGE=(0.5, 0.5), LIGHT_SPECULAR_RANGE=(0.0, 0.0),
                              PIXEL_CHANNEL_NOISE=0.0)
    aug = dataclasses.replace(
        aug, CAM=dataclasses.replace(aug.CAM, XY_STD=0.0, DELTA_Z_RANGE=(0.0, 0.0)),
        BBOX=dataclasses.replace(aug.BBOX, DELTA_SCALE_RANGE=(0.0, 0.0), DELTA_CENTRE_RANGE=(0.0, 0.0)),
        RGB=rgb, PROXY_REP=proxy,
    )
    sd = dataclasses.replace(cfg.TRAIN.SYNTH_DATA, AUGMENT=aug, FOCAL_LENGTH=300.0 * IMG / 256.0)
    cfg.TRAIN = dataclasses.replace(cfg.TRAIN, SYNTH_DATA=sd)
    cfg.DATA = dataclasses.replace(cfg.DATA, PROXY_REP_SIZE=IMG)
    return cfg


def _capturing(renderer, into):
    def render(*args, **kw):
        into.append(renderer(*args, **kw))
        return into[-1]
    return render


def test_synth_batch_matches_jax(record):
    """The whole synthetic batch on the exact render path, collapsed
    augmentations, the JAX draws replayed."""
    jcfg, tcfg = _collapsed(jax_defaults()), _collapsed(torch_defaults())
    focal = tcfg.TRAIN.SYNTH_DATA.FOCAL_LENGTH
    rng = np.random.default_rng(7)
    pose = rng.normal(scale=0.3, size=(B, 72)).astype(np.float32)
    texture = rng.uniform(size=(B, 1200, 800, 3)).astype(np.float32)
    background = rng.uniform(size=(B, IMG, IMG, 3)).astype(np.float32)
    renders = {"jax": [], "torch": []}
    jr = JaxRenderer(img_wh=IMG, projection_type="perspective", focal_length=focal, chunk=4096, emit_overflow=True)
    tr = TorchRenderer(img_wh=IMG, projection_type="perspective", focal_length=focal, chunk=4096,
                       emit_overflow=True, device="cpu")
    with jax.disable_jit():
        want = jax_synth(jcfg, jsmpl.synthetic_smpl(num_verts=6890), _capturing(jr, renders["jax"]))(
            jax.random.PRNGKey(8), jnp.asarray(pose), jnp.asarray(texture), jnp.asarray(background))
    draws = _replay(record)
    got = torch_synth(tcfg, tsmpl.synthetic_smpl(num_verts=6890, device="cpu"), _capturing(tr, renders["torch"]))(
        draws, t(pose), t(texture), t(background))
    assert not draws.recorded
    assert set(got) == set(want)
    assert int(got["binning_overflow"]) == 0

    part_j, part_t = np.asarray(renders["jax"][0]["iuv_images"][..., 0]), renders["torch"][0]["iuv_images"][..., 0]
    assert float((part_t.numpy() == part_j).mean()) >= PIXEL_FRAC
    for k in ("pose_rotmats", "glob_rotmats", "shape"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=1e-5, err_msg=k)
    np.testing.assert_allclose(got["joints2D"].numpy(), np.asarray(want["joints2D"]), rtol=0, atol=PX_ATOL)
    np.testing.assert_array_equal(got["joints2D_vis"].numpy(), np.asarray(want["joints2D_vis"]))
    assert float(got["joints2D_vis"].sum()) > 0
    proxy_t, proxy_j = got["proxy"].numpy(), np.asarray(want["proxy"])
    np.testing.assert_allclose(proxy_t[..., 1:], proxy_j[..., 1:], rtol=0, atol=PX_ATOL)  # heatmaps
    edges = np.abs(proxy_t[..., 0] - proxy_j[..., 0]) <= 1e-4
    rgb = np.abs(got["rgb_in"].numpy() - np.asarray(want["rgb_in"])) <= IMG_ATOL
    print(f"\nsynth batch: part labels {float((part_t.numpy() == part_j).mean()):.5f}, edges {edges.mean():.5f}, "
          f"rgb {rgb.mean():.5f} of the pixels equal")
    assert edges.mean() >= PIXEL_FRAC and rgb.mean() >= PIXEL_FRAC
    assert float(proxy_t[..., 0].max()) > 0 and math.isfinite(float(proxy_t.sum()))
