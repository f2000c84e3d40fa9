"""Rank bodies of the multi-process tests (tests/test_torch_parallel*.py).

Each function runs on one rank that `humaniflow_torch.parallel.spawn`
started (gloo on the CPU), imports torch and humaniflow_torch only, reads
its inputs from a file the test wrote and saves what it computed, one file
per rank, for the test to hold against JAX or against one process.  Each
rank's OpenMP pool is capped at one thread (threadpoolctl, not
torch.set_num_threads: see tests/_torch_parity.py).
"""

import os

import numpy as np
import torch
from threadpoolctl import threadpool_limits


class ListDataset:
    """An eval dataset over a list of item dicts (picklable)."""

    def __init__(self, items):
        self.items = items

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return dict(self.items[i])


class SeededBatches:
    """epoch_batches provider of poses, textures and backgrounds drawn from
    np.random.default_rng(seed), the same in every process."""

    def __init__(self, n, img, seed):
        self.rng = np.random.default_rng(seed)
        self.n, self.img = n, img

    def __len__(self):
        return self.n

    def epoch_batches(self, batch_size, shuffle=True, drop_last=True):
        for _ in range(self.n // batch_size):
            yield {
                "pose": self.rng.normal(scale=0.3, size=(batch_size, 72)).astype(np.float32),
                "texture": self.rng.uniform(size=(batch_size, 1200, 800, 3)).astype(np.float32),
                "background": self.rng.uniform(size=(batch_size, self.img, self.img, 3)).astype(np.float32),
            }


def result(out_dir, name, rank):
    return torch.load(os.path.join(out_dir, f"{name}_rank{rank}.pt"), weights_only=False)


def _save(out_dir, name, rank, obj):
    torch.save(obj, os.path.join(out_dir, f"{name}_rank{rank}.pt"))


def _numpy(tree):
    return {k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v for k, v in tree.items()}


def _replicated_model(cfg_model, state, rank, mesh):
    """A model whose weights differ on each rank until parallel.replicate
    gives every rank rank 0's (`state`)."""
    from humaniflow_torch import parallel
    from humaniflow_torch.models import HumaniflowModel

    model = HumaniflowModel(cfg_model, device="cpu", generator=torch.Generator().manual_seed(100 + rank))
    if rank == 0:
        model.load_state_dict(state)
    return parallel.replicate(model, mesh)


def predict_cases(rank, device, in_path, out_dir):
    """The mesh helpers, the sample split of distribution inference (1×2)
    and predict_humaniflow on 2×1, 1×2 and, padding a batch of 3, on the
    1-D mesh."""
    threadpool_limits(1, user_api="openmp")
    from humaniflow_torch import parallel
    from humaniflow_torch.models import synthetic_smpl
    from humaniflow_torch.pipelines.predict import predict_humaniflow

    inp = torch.load(in_path, weights_only=False)
    mesh = parallel.make_mesh(2)
    x = torch.arange(12.0).reshape(6, 2)
    out = {"shard": parallel.shard_batch({"x": x, "n": np.arange(6)}, mesh)}
    out["shard_2x"] = parallel.shard_batch(x, parallel.make_mesh_2d(1, 2), ("data", "sample"))
    try:
        parallel.shard_batch(torch.zeros(3), mesh)
    except ValueError as e:
        out["indivisible"] = str(e)
    out["replicated"] = parallel.replicate({"t": torch.full((3,), rank + 1.0)}, mesh)["t"]
    model = _replicated_model(inp["cfg"].MODEL, inp["state"], rank, mesh)
    out["weights"] = {k: v.clone() for k, v in model.state_dict().items()}
    smpl = synthetic_smpl(num_verts=inp["num_verts"], device="cpu")

    infer = parallel.make_sharded_inference_fn(model, smpl, parallel.make_mesh_2d(1, 2), num_samples=inp["inf_n"])
    out["infer"] = infer(inp["proxy"], base_noise=inp["inf_noise"])
    images, joints2d, conf = inp["images"], inp["joints2d"], inp["conf"]
    for name, shape in (("2x1", (2, 1)), ("1x2", (1, 2))):
        pred = predict_humaniflow(model, smpl, inp["cfg"], images, joints2d, conf, num_samples=inp["pred_n"],
                                  device="cpu", base_noise=inp["pred_noise"], mesh=parallel.make_mesh_2d(*shape))
        out[f"predict_{name}"] = _numpy(pred)
    pred = predict_humaniflow(model, smpl, inp["cfg"], images[:3], joints2d[:3], conf[:3], num_samples=inp["pred_n"],
                              device="cpu", generator=torch.Generator().manual_seed(7), mesh=mesh,
                              save_dir=os.path.join(out_dir, "padded"), fnames=["a.png", "b.png", "c.png"])
    out["predict_padded"] = _numpy(pred)
    _save(out_dir, "predict", rank, out)


def eval_cases(rank, device, in_path, out_dir):
    """evaluate_humaniflow on the 2-rank data mesh, a batch of 3 (padded
    to 4): with the given noise, and with the noise drawn from a
    generator."""
    threadpool_limits(1, user_api="openmp")
    from humaniflow_torch import parallel
    from humaniflow_torch.models import synthetic_smpl
    from humaniflow_torch.pipelines import evaluate_humaniflow
    from humaniflow_torch.render import TexturedIUVRenderer

    inp = torch.load(in_path, weights_only=False)
    mesh = parallel.make_mesh(2)
    model = _replicated_model(inp["cfg"].MODEL, inp["state"], rank, mesh)
    smpls = [synthetic_smpl(num_verts=inp["num_verts"], seed=s, device="cpu") for s in (0, 1, 2)]
    renderer = TexturedIUVRenderer(img_wh=inp["img"], render_rgb=False, device="cpu")
    noise = inp["noise"]
    out = {}
    for name, kw in (("noise", dict(noise_fn=lambda i, b, n: noise[i], renderer=renderer, **inp["kw"])),
                     ("generator", dict(generator=torch.Generator().manual_seed(3), **inp["generator_kw"]))):
        out[name] = evaluate_humaniflow(model, *smpls, inp["cfg"], ListDataset(inp["items"]), device="cpu",
                                        mesh=mesh, save_path=os.path.join(out_dir, f"mesh_{name}"), **kw)
    _save(out_dir, "eval", rank, out)


def train_cases(rank, device, in_path, out_dir):
    """Data-parallel training on the 2-rank data mesh: two epochs of
    train_humaniflow at a batch of 4, a batch that does not divide, one
    train step with flow BatchNorm, the flow BatchNorm statistics update,
    and the encoder BatchNorm's gradient in float64."""
    threadpool_limits(1, user_api="openmp")
    import dataclasses

    from humaniflow_torch import parallel
    from humaniflow_torch.models import synthetic_smpl
    from humaniflow_torch.models.resnet import BatchNorm
    from humaniflow_torch.pipelines import make_optimizer, make_train_step, train_humaniflow
    from humaniflow_torch.pipelines.train_step import batch_stats_over
    from humaniflow_torch.render import TexturedIUVRenderer

    inp = torch.load(in_path, weights_only=False)
    mesh = parallel.make_mesh(2)
    cfg, img = inp["cfg"], inp["img"]
    model = _replicated_model(cfg.MODEL, inp["state"], rank, mesh)
    smpl = synthetic_smpl(num_verts=6890, device="cpu")
    renderer = TexturedIUVRenderer(img_wh=img, projection_type="perspective",
                                   focal_length=cfg.TRAIN.SYNTH_DATA.FOCAL_LENGTH, chunk=4096, emit_overflow=True,
                                   device="cpu")
    out = {}
    out["params"], _ = train_humaniflow(
        model, smpl, cfg, renderer, *(SeededBatches(cfg.TRAIN.BATCH_SIZE, img, s) for s in (10, 11)),
        os.path.join(out_dir, "mesh"), generator=torch.Generator().manual_seed(42), mesh=mesh, **inp["train_kw"])

    cfg3 = dataclasses.replace(cfg, TRAIN=dataclasses.replace(cfg.TRAIN, BATCH_SIZE=3))
    try:
        train_humaniflow(model, smpl, cfg3, renderer, SeededBatches(3, img, 0), SeededBatches(3, img, 1),
                         os.path.join(out_dir, "indivisible"), num_epochs=1, mesh=mesh)
    except ValueError as e:
        out["indivisible"] = str(e)

    bn_cfg = inp["bn_cfg"]
    bn_model = _replicated_model(bn_cfg.MODEL, inp["bn_state"], rank, mesh)
    step = make_train_step(bn_model, smpl, bn_cfg.LOSS, make_optimizer(bn_model, bn_cfg),
                           img_wh=bn_cfg.DATA.PROXY_REP_SIZE, mesh=mesh)
    out["bn_metrics"] = step(parallel.shard_batch(inp["bn_batch"], mesh), generator=torch.Generator().manual_seed(21))
    out["bn_state"] = bn_model.state_dict()
    out["bn_grads"] = {k: p.grad for k, p in bn_model.named_parameters()}
    stats_model = _replicated_model(bn_cfg.MODEL, inp["bn_state"], rank, mesh)
    with batch_stats_over(stats_model, parallel.axis_group(mesh, "data")):
        stats_model.update_pose_flow_batchnorm_stats(*parallel.shard_batch(inp["stats_inputs"], mesh))
    out["flow_stats"] = stats_model.state_dict()

    bn = BatchNorm(inp["bn64"]["weight"].shape[0]).double()
    bn.load_state_dict(inp["bn64"])
    x, w = parallel.shard_batch((inp["x64"], inp["w64"]), mesh)
    x.requires_grad_(True)
    with batch_stats_over(bn, parallel.axis_group(mesh, "data")):
        (bn(x) * w).sum().backward()
    out["bn64"] = {"x": x.grad, "weight": bn.weight.grad, "bias": bn.bias.grad,
                   "running_mean": bn.running_mean, "running_var": bn.running_var}
    _save(out_dir, "train", rank, out)
