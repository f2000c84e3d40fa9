"""The port's device-parallel layer against humaniflow_tpu/parallel on the
CPU: pad_batch_to_devices (no processes), then on 2 gloo ranks
(tests/_torch_parallel_ranks.py::predict_cases, one spawn for the file)
shard_batch, replicate from ranks that differ, the sample split of
distribution inference on a 1×2 mesh and predict_humaniflow on 2×1 and 1×2
meshes, each against the JAX package's sharded program on its virtual CPU
devices with the same weights and noise, and a padded batch of 3 against
the port's one-process run."""

import dataclasses
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parallel_ranks import predict_cases, result
from _torch_parity import jax_noise, jax_params_from_port, small_cfgs, t

from humaniflow_torch import parallel
from humaniflow_torch.models import HumaniflowModel as TorchModel
from humaniflow_torch.models import synthetic_smpl as t_synthetic_smpl
from humaniflow_torch.pipelines.predict import predict_humaniflow as t_predict
from humaniflow_tpu.models import HumaniflowModel as JaxModel
from humaniflow_tpu.models import synthetic_smpl as j_synthetic_smpl
from humaniflow_tpu.parallel import pad_batch_to_devices as j_pad
from humaniflow_tpu.parallel.sample_parallel import make_mesh_2d as j_mesh_2d
from humaniflow_tpu.parallel.sample_parallel import make_sharded_inference_fn as j_sharded_inference
from humaniflow_tpu.pipelines.predict import predict_humaniflow as j_predict

# tests/test_parallel.py's tolerances: the sample split's vertices atol 1e-5,
# its variance rtol 1e-4 / atol 1e-6 (:103-104); predict's point estimate,
# samples and joints 1e-5, its uncertainty 1e-4 (:138-150).
VERTS_ATOL = 1e-5
VAR_RTOL, VAR_ATOL = 1e-4, 1e-6
PREDICT_TOLS = (("pose_rotmats_point_est", 1e-5), ("verts_point_est", 1e-5), ("verts_samples", 1e-5),
                ("joints_samples", 1e-5), ("vertex_uncertainty_l2", 1e-4))
IMG, V = 32, 128
INF_B, INF_N = 4, 8
PRED_B, PRED_N = 4, 4


def test_pad_batch_to_devices_matches_jax():
    x = np.random.default_rng(0).normal(size=(5, 3)).astype(np.float32)
    want, want_mask = j_pad({"x": jnp.asarray(x)}, 4)
    got, got_mask = parallel.pad_batch_to_devices({"x": t(x), "y": [t(x[:, 0])]}, 4)
    np.testing.assert_array_equal(got["x"].numpy(), np.asarray(want["x"]))
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))
    assert got["y"][0].shape == (8,) and not got["y"][0][5:].any()
    padded, mask = parallel.pad_batch_to_devices((x, None), 4)  # numpy leaves
    assert padded[0].shape == (8, 3) and padded[1] is None and mask.tolist() == [True] * 5 + [False] * 3


def _inputs(seed=3):
    rng = np.random.default_rng(seed)
    images = rng.uniform(size=(PRED_B, IMG, IMG, 3)).astype(np.float32)
    joints2d = rng.uniform(4, IMG - 4, size=(PRED_B, 17, 2)).astype(np.float32)
    conf = rng.uniform(size=(PRED_B, 17)).astype(np.float32)
    proxy = rng.normal(size=(INF_B, IMG, IMG, 18)).astype(np.float32)
    return images, joints2d, conf, proxy


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' results, the JAX package's sharded programs and the
    port's one-process padded predict, on the same weights and noise."""
    root = tmp_path_factory.mktemp("parallel_predict")
    jcfg, tcfg = small_cfgs(18)
    for cfg in (jcfg, tcfg):
        cfg.DATA = dataclasses.replace(cfg.DATA, PROXY_REP_SIZE=IMG)
    jm = JaxModel(jcfg.MODEL)
    source = TorchModel(tcfg.MODEL, device="cpu", generator=torch.Generator().manual_seed(5))
    jparams = jax_params_from_port(source, jm, input_shape=(1, IMG, IMG, 18))
    images, joints2d, conf, proxy = _inputs()
    inf_key, pred_key = jax.random.PRNGKey(2), jax.random.PRNGKey(7)
    inputs = dict(
        cfg=tcfg, state=source.state_dict(), num_verts=V, images=t(images), joints2d=t(joints2d), conf=t(conf),
        proxy=t(proxy), inf_n=INF_N, inf_noise=[t(z) for z in jax_noise(jm, inf_key, INF_B, INF_N)[1]],
        pred_n=PRED_N, pred_noise=[t(z) for z in jax_noise(jm, pred_key, PRED_B, PRED_N)[1]],
    )
    torch.save(inputs, root / "inputs.pt")
    errors = []

    def ranks():
        try:
            parallel.spawn(predict_cases, 2, "cpu", str(root / "inputs.pt"), str(root))
        except BaseException as e:  # raised in the test below
            errors.append(e)

    thread = threading.Thread(target=ranks)
    thread.start()  # the JAX side runs meanwhile
    jsmpl = j_synthetic_smpl(num_verts=V)
    want = {"infer": jax.device_get(j_sharded_inference(jm, jsmpl, j_mesh_2d(1, 2), num_samples=INF_N)(
        jparams, jnp.asarray(proxy), inf_key))}
    for name, shape in (("2x1", (2, 1)), ("1x2", (1, 2))):
        pred = j_predict(jm, jparams, jsmpl, jcfg, images, joints2d, conf, num_samples=PRED_N, key=pred_key,
                         mesh=j_mesh_2d(*shape))
        want[f"predict_{name}"] = {k: np.asarray(v) for k, v in pred.items()}
    single = t_predict(source, t_synthetic_smpl(num_verts=V, device="cpu"), tcfg, images[:3], joints2d[:3],
                       conf[:3], num_samples=PRED_N, device="cpu", generator=torch.Generator().manual_seed(7),
                       save_dir=str(root / "single"), fnames=["a.png", "b.png", "c.png"])
    thread.join()
    if errors:
        raise errors[0]
    got = [result(str(root), "predict", r) for r in (0, 1)]
    return got, want, single, source, root


def test_shard_batch_and_replicate(runs):
    got, _, _, source, _ = runs
    x = np.arange(12.0).reshape(6, 2)
    for r in (0, 1):
        np.testing.assert_array_equal(got[r]["shard"]["x"].numpy(), x[3 * r:3 * r + 3])
        np.testing.assert_array_equal(got[r]["shard"]["n"], np.arange(3 * r, 3 * r + 3))
        np.testing.assert_array_equal(got[r]["shard_2x"].numpy(), x[3 * r:3 * r + 3])  # data-major over (1, 2)
        assert "does not divide" in got[r]["indivisible"]
        # rank 1 started from other values: replicate gives every rank rank 0's
        np.testing.assert_array_equal(got[r]["replicated"].numpy(), [1.0, 1.0, 1.0])
        for k, v in source.state_dict().items():
            assert torch.equal(got[r]["weights"][k], v), (r, k)


def test_sample_split_inference_matches_jax(runs):
    """make_sharded_inference_fn on a 1×2 mesh (each rank K1 on 4 images ×
    4 samples, one all-reduce of the moments) against JAX's on
    make_mesh_2d(1, 2)."""
    got, want, _, _, _ = runs
    want_verts, want_var = want["infer"]
    for r in (0, 1):
        verts, var = got[r]["infer"]
        assert verts.shape == (INF_B, V, 3) and var.shape == (INF_B, V)
        np.testing.assert_allclose(verts.numpy(), want_verts, atol=VERTS_ATOL, rtol=0)
        np.testing.assert_allclose(var.numpy(), want_var, rtol=VAR_RTOL, atol=VAR_ATOL)
    assert torch.equal(got[0]["infer"][1], got[1]["infer"][1])


@pytest.mark.parametrize("mesh", ["2x1", "1x2"])
def test_predict_on_a_mesh_matches_jax(runs, mesh):
    got, want, _, _, _ = runs
    w = want[f"predict_{mesh}"]
    for r in (0, 1):
        g = got[r][f"predict_{mesh}"]
        assert set(g) == set(w)
        assert g["verts_samples"].shape == (PRED_B, PRED_N, V, 3)
        for k, tol in PREDICT_TOLS:
            np.testing.assert_allclose(g[k], w[k], rtol=tol, atol=tol, err_msg=f"{mesh} rank {r} {k}")


def test_padded_predict_matches_one_process(runs):
    """A batch of 3 on the 2-rank data mesh: padded to 4, the noise drawn
    for the 3 images, trimmed; rank 0 alone writes the files."""
    got, _, single, _, root = runs
    for r in (0, 1):
        g = got[r]["predict_padded"]
        assert set(g) == set(single)
        for k, v in single.items():
            assert g[k].shape == tuple(v.shape), k
            np.testing.assert_allclose(g[k], v.numpy(), rtol=1e-5, atol=1e-5, err_msg=f"rank {r} {k}")
    names = sorted(os.listdir(root / "single"))
    assert names == ["a_pred.npz", "b_pred.npz", "c_pred.npz"] and sorted(os.listdir(root / "padded")) == names
    for name in names:
        want, have = np.load(root / "single" / name), np.load(root / "padded" / name)
        assert sorted(have.files) == sorted(want.files)
        for k in want.files:
            np.testing.assert_allclose(have[k], want[k], rtol=1e-5, atol=1e-5, err_msg=f"{name} {k}")
