"""The port's HRNet-W48 against the flax module of humaniflow_tpu on the CPU,
with weights carried across by hrnet_params_from_jax, and the reference
`.pth` loader against the JAX converter."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import random_hrnet_variables, t

from humaniflow_torch.models import hrnet as thrnet
from humaniflow_torch.utils.convert_jax import hrnet_params_from_jax
from humaniflow_torch.utils.load_reference import (
    hrnet_state_from_reference,
    load_hrnet_checkpoint,
    load_torch_state_dict,
)
from humaniflow_tpu.models import hrnet as jhrnet
from humaniflow_tpu.utils.convert_torch import convert_hrnet_checkpoint

# Fully convolutional, so a smaller multiple-of-32 input reaches every layer
# (as tests/test_hrnet.py).  Heatmaps: 1e-4 of the largest |heatmap| (float32
# sums over ~60 layers in other orders).  bf16 against float32: the JAX test's
# 0.02 mean error relative to the heatmaps' spread.
H, W = 96, 64
HEATMAP_RTOL = 1e-4
BF16_REL = 0.02


@pytest.fixture(scope="module")
def hrnets():
    variables = random_hrnet_variables(jhrnet.PoseHighResolutionNet(), (1, H, W, 3), seed=0)
    port = hrnet_params_from_jax(variables, thrnet.PoseHighResolutionNet(device="cpu"))
    return variables, port


def _images(b=2, seed=1):
    return np.random.default_rng(seed).uniform(size=(b, H, W, 3)).astype(np.float32)


def test_param_count_is_w48(hrnets):
    _, port = hrnets
    assert sum(p.numel() for p in port.parameters()) == 63_595_745


def test_heatmaps_match_flax(hrnets):
    variables, port = hrnets
    x = _images()
    want = np.asarray(jhrnet.PoseHighResolutionNet().apply(variables, jnp.asarray(x), train=False))
    with torch.inference_mode():
        got = port(t(x)).numpy()
    assert got.shape == (2, H // 4, W // 4, 17) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=HEATMAP_RTOL * np.abs(want).max(), rtol=0)


def test_keypoint_decode_matches_jax():
    hm = np.zeros((1, 8, 6, 2), np.float32)
    hm[0, 3, 4, 0] = 2.0
    hm[0, 7, 1, 1] = 1.5
    hm[0, 5, 2, 1] = 1.5  # a tie: the first maximum in row-major order wins
    kps, confs = thrnet.get_kp_locations_confs_from_heatmaps(t(hm))
    want_kps, want_confs = jhrnet.get_kp_locations_confs_from_heatmaps(jnp.asarray(hm))
    np.testing.assert_array_equal(kps.numpy(), np.asarray(want_kps))
    np.testing.assert_array_equal(confs.numpy(), np.asarray(want_confs))
    np.testing.assert_array_equal(kps.numpy()[0], [[4, 3], [2, 5]])


def test_bf16_against_float32():
    """bf16 convolutions keep float32 parameters, BatchNorm and heatmaps; at
    trained-magnitude activations (kernels damped ×0.25, identity
    BatchNorm, as the JAX test) they stay within 0.02 of float32."""
    variables = random_hrnet_variables(jhrnet.PoseHighResolutionNet(), (1, H, W, 3), seed=2, kernel_scale=0.25,
                                       random_batchnorm=False)
    m32 = hrnet_params_from_jax(variables, thrnet.PoseHighResolutionNet(device="cpu"))
    m16 = hrnet_params_from_jax(variables, thrnet.PoseHighResolutionNet(dtype=torch.bfloat16, device="cpu"))
    assert all(p.dtype == torch.float32 for p in m16.parameters())
    x = t(_images(b=1, seed=3))
    with torch.inference_mode():
        o32, o16 = m32(x), m16(x)
    assert o16.dtype == torch.float32
    rel = float((o32 - o16).abs().mean() / o32.std())
    assert rel < BF16_REL, rel


def test_hrnet_params_from_jax_rejects_a_missing_tensor(hrnets):
    variables, _ = hrnets
    broken = jax.tree_util.tree_map(lambda a: a, variables)
    del broken["params"]["final_layer"]["bias"]
    with pytest.raises(KeyError, match="final_layer.bias"):
        hrnet_params_from_jax(broken, thrnet.PoseHighResolutionNet(device="cpu"))


def _reference_hrnet_state_dict(variables):
    """A reference-format pose_hrnet_w48 state dict from flax variables: the
    inverse of convert_hrnet_checkpoint's name map."""
    p, s = variables["params"], variables["batch_stats"]
    sd = {}

    def conv(name, node):
        sd[f"{name}.weight"] = torch.from_numpy(np.ascontiguousarray(np.transpose(node["kernel"], (3, 2, 0, 1))))

    def bn(name, node_p, node_s):
        for leaf, a in (("weight", node_p["scale"]), ("bias", node_p["bias"]),
                        ("running_mean", node_s["mean"]), ("running_var", node_s["var"])):
            sd[f"{name}.{leaf}"] = torch.from_numpy(np.array(a))
        sd[f"{name}.num_batches_tracked"] = torch.tensor(0)

    conv("conv1", p["conv1"])
    bn("bn1", p["bn1"], s["bn1"])
    conv("conv2", p["conv2"])
    bn("bn2", p["bn2"], s["bn2"])
    for k in range(4):
        blk, blk_s = p[f"layer1_block{k}"], s[f"layer1_block{k}"]
        for c in (1, 2, 3):
            conv(f"layer1.{k}.conv{c}", blk[f"conv{c}"])
            bn(f"layer1.{k}.bn{c}", blk[f"bn{c}"], blk_s[f"bn{c}"])
        if "downsample_conv" in blk:
            conv(f"layer1.{k}.downsample.0", blk["downsample_conv"])
            bn(f"layer1.{k}.downsample.1", blk["downsample_bn"], blk_s["downsample_bn"])
    for ref, name in (("transition1.0", "transition1_0"), ("transition1.1.0", "transition1_1"),
                      ("transition2.2.0", "transition2_2"), ("transition3.3.0", "transition3_3")):
        conv(f"{ref}.0", p[f"{name}_conv"])
        bn(f"{ref}.1", p[f"{name}_bn"], s[f"{name}_bn"])
    for st, n_modules in zip((2, 3, 4), jhrnet.STAGE_MODULES):
        for m in range(n_modules):
            mod, mod_s = p[f"stage{st}_module{m}"], s[f"stage{st}_module{m}"]
            for b in range(st):
                for k in range(4):
                    blk, blk_s = mod[f"branch{b}_block{k}"], mod_s[f"branch{b}_block{k}"]
                    for c in (1, 2):
                        conv(f"stage{st}.{m}.branches.{b}.{k}.conv{c}", blk[f"conv{c}"])
                        bn(f"stage{st}.{m}.branches.{b}.{k}.bn{c}", blk[f"bn{c}"], blk_s[f"bn{c}"])
            for i in range(st if not (st == 4 and m == n_modules - 1) else 1):
                for j in range(st):
                    ref = f"stage{st}.{m}.fuse_layers.{i}.{j}"
                    if j > i:
                        conv(f"{ref}.0", mod[f"fuse{i}_{j}_conv"])
                        bn(f"{ref}.1", mod[f"fuse{i}_{j}_bn"], mod_s[f"fuse{i}_{j}_bn"])
                    for k in range(i - j):
                        conv(f"{ref}.{k}.0", mod[f"fuse{i}_{j}_conv{k}"])
                        bn(f"{ref}.{k}.1", mod[f"fuse{i}_{j}_bn{k}"], mod_s[f"fuse{i}_{j}_bn{k}"])
    conv("final_layer", p["final_layer"])
    sd["final_layer.bias"] = torch.from_numpy(np.array(p["final_layer"]["bias"]))
    return sd


def test_load_hrnet_checkpoint_matches_the_jax_converter(hrnets, tmp_path):
    """A raw `.pth` in the reference's naming: the port loaded from the file
    equals the JAX converter's output carried across; a missing or an extra
    tensor raises."""
    variables, port = hrnets
    sd = _reference_hrnet_state_dict(variables)
    path = str(tmp_path / "pose_hrnet_w48_384x288.pth")
    torch.save(sd, path)
    converted = convert_hrnet_checkpoint({k: v.numpy() for k, v in load_torch_state_dict(path).items()})
    want = hrnet_params_from_jax(converted, thrnet.PoseHighResolutionNet(device="cpu"))
    got = load_hrnet_checkpoint(path, thrnet.PoseHighResolutionNet(device="cpu"))
    want_sd, got_sd = want.state_dict(), got.state_dict()
    for k in want_sd:
        if not k.endswith("num_batches_tracked"):
            torch.testing.assert_close(got_sd[k], want_sd[k], rtol=0, atol=0, msg=k)
            torch.testing.assert_close(got_sd[k], port.state_dict()[k], rtol=0, atol=0, msg=k)

    del sd["stage3.1.fuse_layers.2.0.1.0.weight"]
    with pytest.raises(KeyError, match="stage3.1.fuse_layers.2.0.1.0.weight"):
        hrnet_state_from_reference(sd, got)
    sd = _reference_hrnet_state_dict(variables)
    sd["head.weight"] = torch.zeros(3)
    with pytest.raises(KeyError, match="head.weight"):
        hrnet_state_from_reference(sd, got)
