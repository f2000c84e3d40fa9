"""Hygiene of the PyTorch port: it imports neither JAX nor the JAX package,
and its entry points refuse to run on the CPU unless asked to."""

import ast
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "humaniflow_tpu")


def _port_sources():
    root = os.path.join(REPO, "humaniflow_torch")
    files = [os.path.join(REPO, "chip_smoke.py")]
    for dirpath, _, names in os.walk(root):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _imported_modules(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "id", None) == "__import__":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield str(node.args[0].value)


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: os.path.relpath(p, REPO))
def test_port_source_imports_no_jax(path):
    bad = [m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{os.path.relpath(path, REPO)} imports {bad}"


def test_port_imports_with_jax_blocked():
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'flax', 'humaniflow_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import humaniflow_torch.pipelines, humaniflow_torch.utils.convert_jax\n"
        "import humaniflow_torch.models.cuda_lbs, humaniflow_torch.utils.cuda_build\n"
        "import humaniflow_torch.render.cuda_coverage, humaniflow_torch.pipelines.evaluate\n"
        "import humaniflow_torch.flows.cuda_level, humaniflow_torch.models.hrnet\n"
        "import humaniflow_torch.pipelines.predict_hrnet, humaniflow_torch.utils.load_reference\n"
        "import humaniflow_torch.cli.run_predict\n"
        "import humaniflow_torch.render.cuda_raster, humaniflow_torch.flows.so3_flow\n"
        "import humaniflow_torch.pipelines.train, humaniflow_torch.pipelines.train_step\n"
        "import humaniflow_torch.data.augmentation, humaniflow_torch.data.joints2d_utils\n"
        "import humaniflow_torch.losses, humaniflow_torch.metrics.train_metrics\n"
        "import humaniflow_torch.utils.checkpoints, humaniflow_torch.utils.profiling\n"
        "import humaniflow_torch.render.cuda_tiled, humaniflow_torch.utils.visualise\n"
        "import humaniflow_torch.pipelines.optimise, humaniflow_torch.cli.run_optimise\n"
        "import humaniflow_torch.cli.run_evaluate, humaniflow_torch.cli.run_train\n"
        "import humaniflow_torch.cli.convert_model_files, humaniflow_torch.data.native_loader\n"
        "import humaniflow_torch.flows.autoregressive, humaniflow_torch.data.datasets\n"
        "import humaniflow_torch.cli.pw3d_preprocess, humaniflow_torch.cli.generate_hrnet_keypoints\n"
        "import humaniflow_torch.ops, humaniflow_torch.utils, humaniflow_torch.data, humaniflow_torch.render\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def _entry_points():
    from humaniflow_torch.cli import (
        generate_hrnet_keypoints,
        pw3d_preprocess,
        run_evaluate,
        run_optimise,
        run_predict,
        run_train,
    )
    from humaniflow_torch.configs import get_humaniflow_cfg_defaults, get_optimise_cfg_defaults
    from humaniflow_torch.models import HumaniflowModel, PoseHighResolutionNet, synthetic_smpl
    from humaniflow_torch.pipelines import (
        EVAL_METRICS_3DPW,
        evaluate_humaniflow,
        make_optimise_fn,
        make_predict_fn,
        make_training_renderer,
        optimise_batch_with_humaniflow_prior,
        predict_hrnet_batch,
        predict_humaniflow,
    )
    from humaniflow_torch.render import TexturedIUVRenderer, load_densepose_uv
    from humaniflow_torch.utils import so3_uniform_sampling

    cfg = get_humaniflow_cfg_defaults()
    smpl = synthetic_smpl(num_verts=64, device="cpu")
    model = HumaniflowModel(cfg.MODEL, device="cpu")
    images = torch.zeros((1, 32, 32, 3)).numpy()
    joints = torch.zeros((1, 17, 2)).numpy()
    return {
        "predict_humaniflow": lambda: predict_humaniflow(model, smpl, cfg, images, joints, num_samples=2),
        "make_predict_fn": lambda: make_predict_fn(model, smpl, cfg),
        "HumaniflowModel": lambda: HumaniflowModel(cfg.MODEL),
        "synthetic_smpl": lambda: synthetic_smpl(num_verts=64),
        "SMPLModel.to": lambda: smpl.to(),
        "evaluate_humaniflow": lambda: evaluate_humaniflow(model, smpl, smpl, smpl, cfg, [], EVAL_METRICS_3DPW),
        "TexturedIUVRenderer": lambda: TexturedIUVRenderer(img_wh=32),
        "PoseHighResolutionNet": lambda: PoseHighResolutionNet(),
        "predict_hrnet_batch": lambda: predict_hrnet_batch(None, [images[0]]),
        "cli.run_predict": lambda: run_predict.main(["-I", REPO, "-S", REPO]),
        "make_optimise_fn": lambda: make_optimise_fn(model, smpl, get_optimise_cfg_defaults()),
        "optimise_batch_with_humaniflow_prior": lambda: optimise_batch_with_humaniflow_prior(
            model, smpl, get_optimise_cfg_defaults(), {}),
        "cli.run_optimise": lambda: run_optimise.main(["-I", REPO, "-P", REPO, "-S", REPO, "-C", "weights.tar"]),
        "cli.run_evaluate": lambda: run_evaluate.main(["-D", "3dpw", "-C", "weights.tar"]),
        "cli.run_train": lambda: run_train.main(["-E", os.path.join(REPO, "build", "no_experiment")]),
        "make_training_renderer": lambda: make_training_renderer(cfg),
        "cli.pw3d_preprocess": lambda: pw3d_preprocess.main(["--pw3d_dir", REPO, "--out_dir", REPO]),
        "cli.generate_hrnet_keypoints": lambda: generate_hrnet_keypoints.main(
            ["--frames_dir", REPO, "--out_path", os.path.join(REPO, "build", "no_keypoints.npy")]),
        "so3_uniform_sampling": lambda: so3_uniform_sampling(2),
        "load_densepose_uv": lambda: load_densepose_uv(),
    }


@pytest.mark.parametrize(
    "name",
    [
        "predict_humaniflow", "make_predict_fn", "HumaniflowModel", "synthetic_smpl", "SMPLModel.to",
        "evaluate_humaniflow", "TexturedIUVRenderer", "PoseHighResolutionNet", "predict_hrnet_batch",
        "cli.run_predict", "make_optimise_fn", "optimise_batch_with_humaniflow_prior", "cli.run_optimise",
        "cli.run_evaluate", "cli.run_train", "make_training_renderer", "cli.pw3d_preprocess",
        "cli.generate_hrnet_keypoints", "so3_uniform_sampling", "load_densepose_uv",
    ],
)
def test_entry_points_default_to_cuda_and_raise_without_it(name):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the entry points run there")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _entry_points()[name]()


def test_make_predict_fn_rejects_a_model_on_another_device():
    from humaniflow_torch.configs import get_humaniflow_cfg_defaults
    from humaniflow_torch.models import HumaniflowModel, synthetic_smpl
    from humaniflow_torch.pipelines import make_predict_fn

    cfg = get_humaniflow_cfg_defaults()
    model = HumaniflowModel(cfg.MODEL, device="cpu")
    smpl = synthetic_smpl(num_verts=64, device="cpu")
    with pytest.raises(ValueError):
        make_predict_fn(model, smpl, cfg, device="meta")


def test_evaluate_humaniflow_rejects_a_model_on_another_device():
    from humaniflow_torch.configs import get_humaniflow_cfg_defaults
    from humaniflow_torch.models import HumaniflowModel, synthetic_smpl
    from humaniflow_torch.pipelines import EVAL_METRICS_3DPW, evaluate_humaniflow

    cfg = get_humaniflow_cfg_defaults()
    model = HumaniflowModel(cfg.MODEL, device="cpu")
    smpl = synthetic_smpl(num_verts=64, device="cpu")
    with pytest.raises(ValueError):
        evaluate_humaniflow(model, smpl, smpl, smpl, cfg, [], EVAL_METRICS_3DPW, device="meta")
