"""Data-parallel training on the CPU, on 2 gloo ranks
(tests/_torch_parallel_ranks.py::train_cases, one spawn for the file), held
to the port's one-process runs as tests/test_train_pipeline.py:125-188
holds the JAX package's mesh run: two epochs of train_humaniflow at a batch
of 4 (2 a rank) on the default flow, every rank's parameters bitwise
equal, a batch that does not divide the ranks; one train step with flow
BatchNorm; and the whole batch's encoder BatchNorm gradient in float64."""

import copy
import dataclasses
import math
import os
import pickle
import threading

import numpy as np
import pytest
import torch
from _torch_parallel_ranks import SeededBatches, result, train_cases
from _torch_parity import randomise_batchnorm

from humaniflow_torch import parallel
from humaniflow_torch.configs import get_humaniflow_cfg_defaults
from humaniflow_torch.models import HumaniflowModel
from humaniflow_torch.models import synthetic_smpl
from humaniflow_torch.models.resnet import BatchNorm
from humaniflow_torch.pipelines import make_optimizer, make_train_step, train_humaniflow
from humaniflow_torch.render import TexturedIUVRenderer

# tests/test_train_pipeline.py:160-170: losses rtol 1e-3, parameters atol
# 2e-3 / rtol 1e-3.  A step's gradients: each tensor within 1e-3 of its
# largest |value| (tests/test_torch_train.py's GRAD_RTOL).  The flow
# BatchNorm running statistics after a step: 1e-5 (chip_smoke.py's
# BN_STATS_RTOL, absolute here).  BatchNorm in float64: 1e-12.
LOSS_RTOL = 1e-3
GRAD_RTOL = 1e-3
PARAM_ATOL, PARAM_RTOL = 2e-3, 1e-3
BN_STATS_ATOL = 1e-5
F64_ATOL = 1e-12
IMG, B = 32, 4
STEP_IMG, STEP_B = 64, 2  # as the port's train-step parity tests, tests/_torch_parity.py (ROADMAP §3)
TRAIN_KW = dict(num_epochs=2, steps_per_epoch=1, metrics_to_track=("PVE", "joints2D-L2E"), save_val_metrics=("PVE",))


def _cfg(img=IMG, **flow):
    cfg = get_humaniflow_cfg_defaults()
    cfg.DATA = dataclasses.replace(cfg.DATA, PROXY_REP_SIZE=img)
    cfg.TRAIN = dataclasses.replace(cfg.TRAIN, BATCH_SIZE=B, EPOCHS_PER_SAVE=1, SYNTH_DATA=dataclasses.replace(
        cfg.TRAIN.SYNTH_DATA, FOCAL_LENGTH=300.0 * IMG / 256.0))
    if flow:
        cfg.MODEL = dataclasses.replace(cfg.MODEL, NORM_FLOW=dataclasses.replace(cfg.MODEL.NORM_FLOW, **flow))
    return cfg


def _bn_flow_model(cfg):
    """The menu's affine coupling + conditional linear PLU + flow BatchNorm,
    with random encoder and flow BatchNorm statistics."""
    model = HumaniflowModel(cfg.MODEL, device="cpu", generator=torch.Generator().manual_seed(11))
    randomise_batchnorm(model)
    gen = torch.Generator().manual_seed(12)
    with torch.no_grad():
        for name, p in model.flow.named_parameters():
            if name.endswith(("log_gamma", "beta", "moving_mean")):
                p.uniform_(-0.3, 0.3, generator=gen)
            elif name.endswith("moving_var"):
                p.uniform_(0.5, 2.0, generator=gen)
    return model


def _step_batch(seed=20, b=STEP_B, img=STEP_IMG):
    from scipy.spatial.transform import Rotation

    rng = np.random.default_rng(seed)
    rot = lambda n: torch.from_numpy(Rotation.from_rotvec(rng.normal(scale=0.6, size=(n, 3))).as_matrix()  # noqa: E731
                                     .astype(np.float32))
    return {
        "proxy": torch.from_numpy(rng.uniform(size=(b, img, img, 18)).astype(np.float32)),
        "pose_rotmats": rot(b * 23).reshape(b, 23, 3, 3), "glob_rotmats": rot(b),
        "shape": torch.from_numpy(rng.normal(size=(b, 10)).astype(np.float32)),
        "joints2D": torch.from_numpy(rng.uniform(0, img, size=(b, 17, 2)).astype(np.float32)),
        "joints2D_vis": torch.from_numpy((rng.uniform(size=(b, 17)) > 0.2).astype(np.float32)),
    }


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("parallel_train")
    cfg = _cfg()
    source = HumaniflowModel(cfg.MODEL, device="cpu", generator=torch.Generator().manual_seed(8))
    randomise_batchnorm(source)
    bn_cfg = _cfg(STEP_IMG, TRANSFORM_TYPE="affine_coupling", PERMUTE_TYPE="conditional_linear_plu", BATCH_NORM=True)
    bn_source = _bn_flow_model(bn_cfg)
    rng = np.random.default_rng(30)
    bn64 = BatchNorm(5).double()
    with torch.no_grad():
        bn64.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, 5)))
        bn64.bias.copy_(torch.from_numpy(rng.normal(size=5)))
    x64, w64 = (torch.from_numpy(rng.normal(loc=1.0, size=(B, 5, 3, 4))) for _ in range(2))
    stats_inputs = (_step_batch(31, b=B)["pose_rotmats"],
                    torch.nn.functional.elu(torch.from_numpy(rng.normal(size=(B, 23, 64)).astype(np.float32))))
    torch.save(dict(cfg=cfg, img=IMG, state=source.state_dict(), train_kw=TRAIN_KW, bn_cfg=bn_cfg,
                    bn_state=bn_source.state_dict(), bn_batch=_step_batch(), stats_inputs=stats_inputs,
                    bn64=bn64.state_dict(), x64=x64, w64=w64), root / "inputs.pt")
    errors = []

    def ranks():
        try:
            parallel.spawn(train_cases, 2, "cpu", str(root / "inputs.pt"), str(root))
        except BaseException as e:  # raised below
            errors.append(e)

    thread = threading.Thread(target=ranks)
    thread.start()  # the one-process runs meanwhile
    smpl = synthetic_smpl(num_verts=6890, device="cpu")
    renderer = TexturedIUVRenderer(img_wh=IMG, projection_type="perspective",
                                   focal_length=cfg.TRAIN.SYNTH_DATA.FOCAL_LENGTH, chunk=4096, emit_overflow=True,
                                   device="cpu")
    want = {}
    want["params"], _ = train_humaniflow(
        copy.deepcopy(source), smpl, cfg, renderer, *(SeededBatches(B, IMG, s) for s in (10, 11)),
        str(root / "single"), generator=torch.Generator().manual_seed(42), **TRAIN_KW)
    want["bn_initial"] = {k: v.clone() for k, v in bn_source.state_dict().items()}
    stats_model = copy.deepcopy(bn_source)
    stats_model.update_pose_flow_batchnorm_stats(*stats_inputs)
    want["flow_stats"] = stats_model.state_dict()
    step = make_train_step(bn_source, smpl, bn_cfg.LOSS, make_optimizer(bn_source, bn_cfg), img_wh=STEP_IMG)
    want["bn_metrics"] = step(_step_batch(), generator=torch.Generator().manual_seed(21))
    want["bn_state"] = bn_source.state_dict()
    want["bn_grads"] = {k: p.grad for k, p in bn_source.named_parameters()}
    x64 = x64.clone().requires_grad_(True)
    bn64.train()
    (bn64(x64) * w64).sum().backward()
    want["bn64"] = {"x": x64.grad, "weight": bn64.weight.grad, "bias": bn64.bias.grad,
                    "running_mean": bn64.running_mean, "running_var": bn64.running_var}
    thread.join()
    if errors:
        raise errors[0]
    return [result(str(root), "train", r) for r in (0, 1)], want, root


def _log(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def test_data_parallel_training_matches_one_process(runs):
    got, want, root = runs
    single, mesh = _log(root / "single" / "log.pkl"), _log(root / "mesh" / "log.pkl")
    assert len(single["train_losses"]) == 2 and all(math.isfinite(x) for x in mesh["val_losses"])
    for k in ("train_losses", "val_losses", "train_PVE", "val_PVE", "val_joints2D-L2E"):
        np.testing.assert_allclose(mesh[k], single[k], rtol=LOSS_RTOL, err_msg=k)
    for k, w in want["params"].items():
        np.testing.assert_allclose(got[0]["params"][k].numpy(), w.numpy(), atol=PARAM_ATOL, rtol=PARAM_RTOL,
                                   err_msg=k)
    assert sorted(os.listdir(root / "mesh")) == sorted(os.listdir(root / "single"))  # rank 0's checkpoints


def test_every_rank_ends_with_the_same_bits(runs):
    got, _, _ = runs
    for k, v in got[0]["params"].items():
        assert torch.equal(got[1]["params"][k], v), k
    for k, v in got[0]["bn_state"].items():
        assert torch.equal(got[1]["bn_state"][k], v), k


def test_a_batch_that_does_not_divide_raises(runs):
    got, _, _ = runs
    for r in (0, 1):
        assert "TRAIN.BATCH_SIZE=3 must divide the mesh device count 2 (remainder 1)" in got[r]["indivisible"]


def test_flow_batchnorm_step_matches_one_process(runs):
    """One step with flow BatchNorm: the whole batch's loss terms, the
    averaged gradient and the encoder's running statistics; and the flow
    BatchNorm statistics update on a batch of 4 (2 a rank).  The flow's
    statistics after the step are not compared: Adam's first step moves a
    parameter whose gradient is float noise by up to its learning rate."""
    got, want, _ = runs
    for k in ("pose_nll", "shape_nll", "joints2D", "glob_rotmats", "total", "grad_norm"):
        np.testing.assert_allclose(float(got[0]["bn_metrics"][k]), float(want["bn_metrics"][k]), rtol=LOSS_RTOL,
                                   err_msg=k)
    assert float(got[0]["bn_metrics"]["nan_skipped"]) == 0.0
    for k, w in want["bn_grads"].items():
        scale = max(float(w.abs().max()), 1e-30)
        assert float((got[0]["bn_grads"][k] - w).abs().max()) <= GRAD_RTOL * scale, k
        assert torch.equal(got[1]["bn_grads"][k], got[0]["bn_grads"][k]), k
    encoder = [k for k in want["bn_state"] if k.endswith(("running_mean", "running_var"))]
    flow = [k for k in want["flow_stats"] if k.endswith(("moving_mean", "moving_var"))]
    assert encoder and len(flow) == 4  # two flow BatchNorm layers
    for name, keys in (("bn_state", encoder), ("flow_stats", flow)):
        for k in keys:
            np.testing.assert_allclose(got[0][name][k].numpy(), want[name][k].numpy(), atol=BN_STATS_ATOL, rtol=0,
                                       err_msg=k)
    assert all(not torch.equal(got[0]["flow_stats"][k], want["bn_initial"][k]) for k in flow)  # the update moved them


def test_global_batchnorm_gradient_float64(runs):
    """The encoder BatchNorm over the group: each rank's input gradient is
    its block of the one-process gradient, the weight and bias gradients
    sum to it, and the running statistics are the whole batch's."""
    got, want, _ = runs
    w = want["bn64"]
    x = torch.cat([got[r]["bn64"]["x"] for r in (0, 1)])
    torch.testing.assert_close(x, w["x"], atol=F64_ATOL, rtol=0)
    for k in ("weight", "bias"):
        torch.testing.assert_close(got[0]["bn64"][k] + got[1]["bn64"][k], w[k], atol=F64_ATOL, rtol=0)
    for k in ("running_mean", "running_var"):
        for r in (0, 1):
            torch.testing.assert_close(got[r]["bn64"][k], w[k], atol=F64_ATOL, rtol=0)
