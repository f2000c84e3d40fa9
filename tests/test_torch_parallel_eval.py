"""Data-parallel evaluation on the CPU: evaluate_humaniflow on 2 gloo ranks
(tests/_torch_parallel_ranks.py::eval_cases, one spawn for the file), a
batch of 3 that pads to 4, each rank rendering its own silhouettes, held
to the port's one-process run (as tests/test_evaluate.py:321 holds the
JAX package's mesh run) and to the JAX package's single-device run, with
the same weights and the JAX key pool as noise; and with the noise drawn
from a generator, held to the one-process run with the same generator."""

import dataclasses
import os
import threading

import jax
import numpy as np
import pytest
import torch
from _torch_parallel_ranks import ListDataset, eval_cases, result
from _torch_parity import jax_noise, jax_params_from_port, rel_err, t
from test_torch_eval import _FakeEvalDataset

from humaniflow_torch import parallel
from humaniflow_torch.configs import get_humaniflow_cfg_defaults as torch_defaults
from humaniflow_torch.models import HumaniflowModel as TorchModel
from humaniflow_torch.models import synthetic_smpl as t_synthetic_smpl
from humaniflow_torch.pipelines import EVAL_METRICS_SSP3D
from humaniflow_torch.pipelines import evaluate_humaniflow as t_evaluate
from humaniflow_torch.render import TexturedIUVRenderer as TorchRenderer
from humaniflow_tpu.configs import get_humaniflow_cfg_defaults as jax_defaults
from humaniflow_tpu.models import HumaniflowModel as JaxModel
from humaniflow_tpu.models import synthetic_smpl as j_synthetic_smpl
from humaniflow_tpu.pipelines.evaluate import evaluate_humaniflow as j_evaluate
from humaniflow_tpu.render import TexturedIUVRenderer as JaxRenderer

# Mesh against one process: rtol 1e-4 (tests/test_evaluate.py:344).
# Against JAX: the evaluation slice's rel 2e-4, the IOU metrics abs 2e-2
# (docs/PARITY.md, tests/test_torch_eval.py).
MESH_RTOL = 1e-4
METRIC_RTOL = 2e-4
IOU_ATOL = 2e-2
IMG, B, N = 32, 3, 3
GENERATOR_METRICS = ["PVE", "MPJPE", "joints2D-L2E", "PVE_samples_min"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("parallel_eval")
    cfgs = []
    for cfg in (jax_defaults(), torch_defaults()):
        cfg.DATA = dataclasses.replace(cfg.DATA, PROXY_REP_SIZE=IMG)
        cfgs.append(cfg)
    jcfg, tcfg = cfgs
    jm = JaxModel(jcfg.MODEL)
    source = TorchModel(tcfg.MODEL, device="cpu", generator=torch.Generator().manual_seed(6))
    jparams = jax_params_from_port(source, jm, input_shape=(1, IMG, IMG, 18))
    # evaluate_humaniflow's key pool: split(PRNGKey(0), 65), keys popped from the end
    shape, levels = jax_noise(jm, jax.random.split(jax.random.PRNGKey(0), 65)[64], B, N)
    noise = [(t(shape.astype(np.float32)), [t(z) for z in levels])]
    dataset = _FakeEvalDataset(n=B)
    kw = dict(metrics=list(EVAL_METRICS_SSP3D), batch_size=B, num_pred_samples=N, save_per_frame_metrics=True,
              silhouette_sample_chunk=2)
    generator_kw = dict(metrics=GENERATOR_METRICS, batch_size=B, num_pred_samples=N, save_per_frame_metrics=True)
    torch.save(dict(cfg=tcfg, state=source.state_dict(), num_verts=6890, img=IMG, noise=noise, kw=kw,
                    generator_kw=generator_kw, items=[dataset[i] for i in range(B)]), root / "inputs.pt")
    errors = []

    def ranks():
        try:
            parallel.spawn(eval_cases, 2, "cpu", str(root / "inputs.pt"), str(root))
        except BaseException as e:  # raised below
            errors.append(e)

    thread = threading.Thread(target=ranks)
    thread.start()  # JAX and the one-process runs meanwhile
    want = {"jax": j_evaluate(jm, jparams, *[j_synthetic_smpl(num_verts=6890, seed=s) for s in (0, 1, 2)], jcfg,
                              _FakeEvalDataset(n=B), renderer=JaxRenderer(img_wh=IMG, projection_type="orthographic",
                                                                          render_rgb=False),
                              save_path=str(root / "jax"), **kw)}
    smpls = [t_synthetic_smpl(num_verts=6890, seed=s, device="cpu") for s in (0, 1, 2)]
    want["noise"] = t_evaluate(source, *smpls, tcfg, ListDataset([dataset[i] for i in range(B)]),
                               noise_fn=lambda i, b, n: noise[i], renderer=TorchRenderer(img_wh=IMG, render_rgb=False,
                                                                                          device="cpu"),
                               save_path=str(root / "single_noise"), device="cpu", **kw)
    want["generator"] = t_evaluate(source, *smpls, tcfg, _FakeEvalDataset(n=B), device="cpu",
                                   generator=torch.Generator().manual_seed(3), save_path=str(root / "single_generator"),
                                   **generator_kw)
    thread.join()
    if errors:
        raise errors[0]
    return [result(str(root), "eval", r) for r in (0, 1)], want, root


def _per_frame(d):
    return {f: np.load(os.path.join(d, f)) for f in sorted(os.listdir(d)) if f.endswith("_per_frame.npy")}


@pytest.mark.parametrize("noise", ["noise", "generator"])
def test_padded_evaluation_matches_one_process(runs, noise):
    """Point metrics and sample metrics, on every rank (broadcast from rank
    0), and rank 0's per-frame files against the one-process files."""
    got, want, root = runs
    for r in (0, 1):
        assert got[r][noise] == got[0][noise]
        assert set(got[r][noise]) == set(want[noise])
        for m, v in want[noise].items():
            np.testing.assert_allclose(got[r][noise][m], v, rtol=MESH_RTOL, err_msg=m)
    have, single = _per_frame(root / f"mesh_{noise}"), _per_frame(root / f"single_{noise}")
    assert sorted(have) == sorted(single) and len(single) >= 8
    np.testing.assert_array_equal(have.pop("fname_per_frame.npy"), single.pop("fname_per_frame.npy"))
    for f, w in single.items():
        assert have[f].shape == w.shape and w.shape[0] == B, f
        np.testing.assert_allclose(have[f], w, rtol=MESH_RTOL, atol=0, err_msg=f)


def test_padded_evaluation_matches_jax(runs):
    got, want, root = runs
    for m, w in want["jax"].items():
        if "IOU" in m:
            np.testing.assert_allclose(got[0]["noise"][m], w, atol=IOU_ATOL, rtol=0, err_msg=m)
        else:
            np.testing.assert_allclose(got[0]["noise"][m], w, rtol=METRIC_RTOL, atol=0, err_msg=m)
    have, jax_files = _per_frame(root / "mesh_noise"), _per_frame(root / "jax")
    np.testing.assert_array_equal(have.pop("fname_per_frame.npy"), jax_files.pop("fname_per_frame.npy"))
    for f, w in jax_files.items():
        if "IOU" in f:
            np.testing.assert_allclose(have[f], w, atol=IOU_ATOL, rtol=0, err_msg=f)
        else:
            assert rel_err(have[f], w) <= METRIC_RTOL, f
