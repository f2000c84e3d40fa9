"""Prediction pipeline: cropped image → proxy → distribution inference → SMPL
meshes, per-vertex uncertainty and prediction dumps.

The PyTorch counterpart of `humaniflow_tpu/pipelines/predict.py`: Canny +
heatmap proxy build, the N-sample forward with the point estimate as sample
0, SMPL (kernel K2) for the point estimate, the T-pose and every sample, and
the per-vertex variance.  On CUDA, distribution inference replays one CUDA
graph per model and shapes (`_graphed_predict`).  With a device mesh
(parallel/) it runs eagerly: each rank runs its data block of the batch, the
B·N sample SMPL stage splits over both axes of a ("data", "sample") mesh,
and every rank ends with the whole batch.
"""

import os
import weakref
from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from ..configs.defaults import HumaniflowConfig
from ..data.label_conversions import convert_2d_joints_to_gaussian_heatmaps
from ..flows import cuda_level
from ..models.canny import CannyEdgeDetector
from ..models.humaniflow import HumaniflowModel
from ..models.smpl import SMPLModel, smpl_forward
from ..parallel.mesh import DATA_AXIS, all_gather_tree, axis_group, axis_size, pad_batch_to_devices, shard_batch
from ..utils.device import resolve_device
from ..utils.sampling import compute_vertex_variance_from_samples
from ..utils.tracing import count, enabled, span, traced


@traced("proxy")
def build_proxy_representation(
    image: torch.Tensor,
    joints2d: torch.Tensor,
    joints2d_conf: Optional[torch.Tensor],
    cfg: HumaniflowConfig,
    edge_detector: Optional[CannyEdgeDetector] = None,
    joints2d_visib_threshold: float = 0.75,
):
    """Edge channel + 17 joint-heatmap channels → (B, wh, wh, 18) proxy."""
    if edge_detector is None:
        edge_detector = CannyEdgeDetector(
            non_max_suppression=cfg.DATA.EDGE_NMS,
            gaussian_filter_std=cfg.DATA.EDGE_GAUSSIAN_STD,
            gaussian_filter_size=cfg.DATA.EDGE_GAUSSIAN_SIZE,
            threshold=cfg.DATA.EDGE_THRESHOLD,
        )
    with span("proxy.edges"):
        edges = edge_detector(image)
        edge_img = edges["thresholded_thin_edges"] if cfg.DATA.EDGE_NMS else edges["thresholded_grad_magnitude"]
    with span("proxy.heatmaps"):
        heatmaps = convert_2d_joints_to_gaussian_heatmaps(
            joints2d, cfg.DATA.PROXY_REP_SIZE, std=cfg.DATA.HEATMAP_GAUSSIAN_STD
        )  # (B, 17, wh, wh)
        if joints2d_conf is not None:
            # occlusion gating applies to appendage joints only; head and torso
            # (0..6) are always kept
            vis = joints2d_conf > joints2d_visib_threshold
            vis[:, :7] = True
            heatmaps = heatmaps * vis[:, :, None, None]
    return torch.cat([edge_img, heatmaps.permute(0, 2, 3, 1)], dim=-1)


def make_predict_fn(
    model: HumaniflowModel,
    smpl: SMPLModel,
    cfg: HumaniflowConfig,
    num_samples: int = 50,
    use_shape_mode_for_samples: bool = True,
    device=None,
    mesh=None,
):
    """proxy (B, wh, wh, 18) → full distribution-inference outputs.

    On CUDA with no mesh and on K5's route, with the shape mode for the
    samples, the call is one CUDA graph of `_predict_body`, captured at a
    model's first call at its shapes and replayed after (see
    `_graphed_predict`); the noise is drawn eagerly before it, as apply
    draws it, so the outputs are the eager body's bits.

    :param device: default CUDA (raises if unavailable); model and smpl must
        already live there.
    :param mesh: optional DeviceMesh (parallel/).  A 1-D "data" mesh shards
        the batch, which must divide its size; a 2-D ("data", "sample") mesh
        (parallel.make_mesh_2d) also splits the flat B·N sample SMPL stage
        over both axes: rank (d, s) runs flat block d·S + s.  Every rank
        passes the whole proxy and the same noise, and gets the whole batch.
    :return: predict(proxy, generator=None, base_noise=None) → dict; the
        noise arguments are those of HumaniflowModel.apply, for the whole
        batch.
    """
    device = resolve_device(device)
    for name, dev in (("model", model.device), ("smpl", smpl.device)):
        if dev.type != device.type or (device.index is not None and dev.index != device.index):
            raise ValueError(f"{name} lives on {dev}, not on {device}")
    if mesh is not None:
        sample_shards = axis_size(mesh, "sample")
        assert num_samples % sample_shards == 0, (
            f"num_samples={num_samples} must divide the sample axis ({sample_shards})"
        )

    @torch.inference_mode()
    @traced("dist_infer")
    def predict(proxy, generator: Optional[torch.Generator] = None, base_noise: Optional[List] = None):
        if (use_shape_mode_for_samples and (generator is not None or base_noise is not None)
                and _graph_route(model, proxy.device, mesh)):
            if base_noise is None:  # drawn as apply draws it
                base_noise = model._draw_level_noise((proxy.shape[0], num_samples), generator)
            return _graphed_predict(model, smpl, num_samples, proxy, list(base_noise))
        return _predict_body(model, smpl, num_samples, use_shape_mode_for_samples, mesh, proxy, generator,
                             base_noise)

    return predict


def _predict_body(model: HumaniflowModel, smpl: SMPLModel, num_samples: int, use_shape_mode_for_samples: bool,
                  mesh, proxy, generator: Optional[torch.Generator] = None, base_noise: Optional[List] = None,
                  shape_noise: Optional[torch.Tensor] = None) -> Dict:
    """Distribution inference, eagerly: the encoder and heads, the (B, N+1)
    flow pass, SMPL (K2) at B, B and B·N rows, the per-vertex variance;
    arguments as make_predict_fn's and its function's (shape_noise:
    HumaniflowModel.apply's)."""
    sample_shards = 1 if mesh is None else axis_size(mesh, "sample")
    if mesh is not None:
        # the whole batch's noise, then this rank's data block of it and of the proxy
        if base_noise is None:
            shape_noise, base_noise = model.draw_noise(proxy.shape[0], num_samples, generator,
                                                       use_shape_mode_for_samples)
        proxy, base_noise, shape_noise = shard_batch((proxy, list(base_noise), shape_noise), mesh)
    out = model.apply(
        proxy,
        generator=generator,
        num_samples=num_samples,
        use_shape_mode_for_samples=use_shape_mode_for_samples,
        return_input_feats=True,
        base_noise=base_noise,
        shape_noise=shape_noise,
    )
    b = proxy.shape[0]
    with span("smpl"):
        pe = smpl_forward(smpl, out["shape_mode"], out["pose_rotmats_point_est"], out["glob_rotmat"])
    eye = torch.eye(3, device=proxy.device)
    with span("smpl"):
        tpose = smpl_forward(smpl, out["shape_mode"], eye.expand(b, 23, 3, 3), eye.expand(b, 3, 3))

    n = num_samples
    flat_in = (
        out["shape_samples"].reshape(b * n, -1),
        out["pose_rotmats_samples"].reshape(b * n, 23, 3, 3),
        out["glob_rotmat"][:, None].expand(b, n, 3, 3).reshape(b * n, 3, 3),
    )
    if sample_shards > 1:
        # this rank's block of the data block's b·N rows: flat block d·S + s of B·N
        flat_in = shard_batch(flat_in, mesh, "sample")
    with span("smpl"):
        flat = smpl_forward(smpl, *flat_in)
    pred = {
        "cam_wp": out["cam_wp"],
        "glob_rotmat": out["glob_rotmat"],
        "shape_mode": out["shape_mode"],
        "shape_log_std": out["shape_log_std"],
        "pose_axisangle_point_est": out["pose_axisangle_point_est"],
        "pose_rotmats_point_est": out["pose_rotmats_point_est"],
        "pose_rotmats_samples": out["pose_rotmats_samples"],
        "shape_samples": out["shape_samples"],
        "input_feats": out["input_feats"],
        "verts_point_est": pe["vertices"],
        "joints_point_est": pe["joints"],
        "tpose_verts": tpose["vertices"],
    }
    flat_out = {"vertices": flat["vertices"], "joints": flat["joints"]}
    if mesh is not None:
        # the ranks of one "sample" line hold the same rows; the flat
        # blocks are in rank order (d·S + s) over the whole group
        data_group = axis_group(mesh, DATA_AXIS)
        pred = all_gather_tree(pred, data_group)
        flat_out = all_gather_tree(flat_out, data_group if sample_shards == 1 else torch.distributed.group.WORLD)
        b = pred["cam_wp"].shape[0]
    nv = flat_out["vertices"].shape[1]
    verts_samples = flat_out["vertices"].reshape(b, n, nv, 3)
    with span("variance"):
        avg_l2, directional_std = compute_vertex_variance_from_samples(verts_samples)
    pred.update(
        verts_samples=verts_samples,
        joints_samples=flat_out["joints"].reshape(b, n, -1, 3),
        vertex_uncertainty_l2=avg_l2,
        vertex_uncertainty_directional=directional_std,
    )
    return pred


# ------------------------------------------------------- the CUDA graph route
#
# Eager, a call of distribution inference is ~1,100 small launches for ~13 ms
# of device work (an H100 at B = 32, N = 100), so the host's launches set its
# pace.  On the graph route the body runs as one CUDA graph per model and
# shapes, captured at the first call and replayed after: the same kernels (K5
# and K2 among them) in the same order, with no host between them.

GRAPHS_PER_MODEL = 4  # the shapes whose graphs a model keeps, the least recently used dropped first
_GRAPHS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()  # model → OrderedDict(shape key → _Graphed)


def _graph_route(model: HumaniflowModel, device: torch.device, mesh) -> bool:
    """Whether a call replays a CUDA graph: on CUDA, with no mesh (the body's
    collectives stay eager) and on K5's route (the model's rule: grad mode
    off and a flow K5 takes; the eager flow's Permute indexes by a host
    list, which a capture refuses)."""
    return device.type == "cuda" and mesh is None and model._fused_level_enabled()


def _layout(t: torch.Tensor):
    return tuple(t.shape), t.stride(), t.dtype, t.device


def _shape_key(smpl: SMPLModel, num_samples: int, proxy, base_noise) -> tuple:
    """What a graph's shapes depend on: the SMPL object, N and the inputs'
    layouts (B among them)."""
    return id(smpl), num_samples, _layout(proxy), tuple(_layout(t) for t in base_noise)


def _state_key(model: HumaniflowModel, smpl: SMPLModel) -> tuple:
    """Where each parameter, buffer and SMPL tensor lies, and the key of K5's
    weight pack: a graph reads the tensors where they lay at its capture, so
    a write in place needs no new capture, but K5 reads a packed copy of the
    hypernet's, remade on such a write (flows/cuda_level.py)."""
    tensors = [*model.parameters(), *model.buffers(), *(v for v in vars(smpl).values() if isinstance(v, torch.Tensor))]
    return tuple(t.data_ptr() for t in tensors), cuda_level.pack_state(model.flow)[0]


def _capture(body, inputs: List[torch.Tensor]):
    """The documented recipe: body(*inputs) eagerly on a side stream (the
    warm-up: kernel builds, K5's pack, cuBLAS and cuDNN state), then body on
    copies of the inputs captured as a CUDA graph on that stream.  Returns
    (the copies, the graph, its outputs, the warm-up's outputs)."""
    device = inputs[0].device
    static = [t.clone() for t in inputs]
    stream = torch.cuda.Stream(device)
    stream.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(stream):
        first = body(*inputs)
    torch.cuda.current_stream(device).wait_stream(stream)
    for t in first.values():  # made on the side stream, read on the caller's
        t.record_stream(torch.cuda.current_stream(device))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        out = body(*static)
    return static, graph, out, first


@dataclass
class _Graphed:
    """One captured call: the state it was captured at, what its kernels read
    that nothing else keeps alive (the SMPL object, K5's packs), its static
    inputs, the graph and its outputs in the graph's pool."""

    state: tuple
    keep: tuple
    inputs: List[torch.Tensor]
    graph: "torch.cuda.CUDAGraph"
    out: Dict[str, torch.Tensor]

    def replay(self, inputs: List[torch.Tensor]) -> Dict:
        for dst, src in zip(self.inputs, inputs):
            dst.copy_(src)
        self.graph.replay()
        # callers keep predictions, and the next replay overwrites the pool
        return {k: v.clone() for k, v in self.out.items()}


def _graphed_predict(model: HumaniflowModel, smpl: SMPLModel, num_samples: int, proxy, base_noise) -> Dict:
    """_predict_body through the model's graph for these shapes: captured at
    the first call (which returns the eager warm-up's outputs) and again
    whenever a tensor it reads moved or K5's pack was remade, replayed
    otherwise; counted on the open span as graph_captures or graph_replays."""
    graphs = _GRAPHS.setdefault(model, OrderedDict())
    key = _shape_key(smpl, num_samples, proxy, base_noise)
    state = _state_key(model, smpl)
    inputs = [proxy, *base_noise]
    entry = graphs.pop(key, None)
    if entry is not None and entry.state == state:
        graphs[key] = entry  # the most recently used
        count("graph_replays", 1)
        return entry.replay(inputs)
    del entry  # its pool goes before the new capture takes one
    while len(graphs) >= GRAPHS_PER_MODEL:
        graphs.popitem(last=False)

    def body(proxy, *noise):
        return _predict_body(model, smpl, num_samples, True, None, proxy, None, list(noise))

    static, graph, out, first = _capture(body, inputs)
    keep = (smpl, cuda_level.pack_state(model.flow)[1])
    graphs[key] = _Graphed(state, keep, static, graph, out)
    count("graph_captures", 1)
    return first


def save_pred_output(pred: Dict, fnames, save_dir: str, extras: Optional[Dict] = None):
    """Per-image prediction npz dumps, incl. the cached encoder features and
    the crop/keypoint context that the optimise pipeline reloads."""
    os.makedirs(save_dir, exist_ok=True)
    keys = (
        "cam_wp", "glob_rotmat", "shape_mode", "shape_log_std",
        "pose_axisangle_point_est", "pose_rotmats_point_est", "input_feats",
    )
    to_np = lambda a: a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)  # noqa: E731
    np_pred = {k: to_np(pred[k]) for k in keys if k in pred}
    if extras:
        np_pred.update({k: to_np(v) for k, v in extras.items()})
    for i, fname in enumerate(fnames):
        np.savez(
            os.path.join(save_dir, os.path.splitext(fname)[0] + "_pred.npz"),
            **{k: v[i] for k, v in np_pred.items()},
        )


@traced("predict")
def predict_humaniflow(
    model: HumaniflowModel,
    smpl: SMPLModel,
    cfg: HumaniflowConfig,
    images: np.ndarray,
    joints2d: np.ndarray,
    joints2d_conf: Optional[np.ndarray] = None,
    num_samples: int = 50,
    generator: Optional[torch.Generator] = None,
    save_dir: Optional[str] = None,
    fnames=None,
    extras: Optional[Dict] = None,
    joints2d_visib_threshold: float = 0.75,
    device=None,
    base_noise: Optional[List] = None,
    mesh=None,
) -> Dict:
    """Batched prediction over pre-cropped images.

    :param images: (B, wh, wh, 3) RGB in [0, 1]; :param joints2d: (B, 17, 2)
        keypoints in crop coordinates (e.g. from HRNet); numpy arrays or
        tensors.
    :param generator: sampling noise; default a generator on `device` seeded
        with 0.  :param base_noise: explicit per-level noise instead.
    :param device: default CUDA; raises if CUDA is unavailable.
    :param mesh: optional DeviceMesh (parallel/), on which every rank calls
        this with the same inputs: the proxy is padded with zeros to the
        "data" axis only (on a 2-D mesh "sample" splits N, not B) and each
        rank predicts its block; the noise is drawn for the B real images,
        so the result is the one-process result.  Every rank gets the whole
        batch; rank 0 alone writes the files.
    """
    device = resolve_device(device)
    as_t = lambda a: torch.as_tensor(a if isinstance(a, torch.Tensor) else np.asarray(a), device=device)  # noqa: E731
    with span("predict.upload"):
        if enabled() and device.type != "cpu":  # the bytes of the host arrays that the copies move
            count("h2d_bytes", sum(np.asarray(a).nbytes for a in (images, joints2d, joints2d_conf)
                                   if a is not None and not (isinstance(a, torch.Tensor) and a.device.type != "cpu")))
        image_t, joints2d_t = as_t(images).to(torch.float32), as_t(joints2d)
        conf_t = None if joints2d_conf is None else as_t(joints2d_conf)
    proxy = build_proxy_representation(image_t, joints2d_t, conf_t, cfg,
                                       joints2d_visib_threshold=joints2d_visib_threshold)
    predict = make_predict_fn(model, smpl, cfg, num_samples=num_samples, device=device, mesh=mesh)
    if generator is None and base_noise is None:
        generator = torch.Generator(device).manual_seed(0)
    if mesh is None:
        pred = predict(proxy, generator, base_noise)
    else:
        b = proxy.shape[0]
        if base_noise is None:
            _, base_noise = model.draw_noise(b, num_samples, generator, use_shape_mode_for_samples=True)
        (padded, base_noise), _ = pad_batch_to_devices((proxy, list(base_noise)), axis_size(mesh, DATA_AXIS))
        pred = {k: v[:b] for k, v in predict(padded, None, base_noise).items()}
    pred["proxy_rep"] = proxy
    if save_dir is not None and fnames is not None and (mesh is None or torch.distributed.get_rank() == 0):
        all_extras = {"cropped_image": images, "cropped_joints2D": joints2d, "proxy_rep": proxy}
        if joints2d_conf is not None:
            all_extras["hrnet_joints2D_conf"] = joints2d_conf
        if extras:
            all_extras.update(extras)
        save_pred_output(pred, fnames, save_dir, extras=all_extras)
    return pred
