"""SMPL body model in PyTorch: blend shapes, pose blend shapes, skinning.

The counterpart of `humaniflow_tpu/models/smpl.py`, with the same output
joint layout: 24 kinematic joints, 21 vertex landmarks, then the extra (9),
cocoplus (19) and h36m (17) regressed joints, 90 in all.  The vertex pass
(template + blend shapes + skinning) is kernel K2 and the per-group sample
moments kernel K1, both in models/cuda_lbs.py; on the CPU their plain twins
run instead.  `smpl_forward` goes through K2's autograd Function, so
gradients reach the shape and the rotations on both devices.
"""

import os
import pickle
from dataclasses import dataclass, field, fields
from typing import Optional

import numpy as np
import torch

from ..ops.so3 import so3_exp
from ..render.renderer import load_densepose_uv_host
from ..utils.device import resolve_device
from . import cuda_lbs

SMPL_PARENTS = (
    -1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17, 18,
    19, 20, 21,
)
NUM_SMPL_JOINTS = 24
NUM_BODYPARTS = 23

# smplx VertexJointSelector vertex ids: 5 face + 6 feet + 10 fingertips.
_EXTRA_VERTEX_IDS = (
    332, 6260, 2800, 4071, 583,
    3216, 3226, 3387, 6617, 6624, 6787,
    2746, 2319, 2445, 2556, 2673,
    6191, 5782, 5905, 6016, 6133,
)

_ARRAY_FIELDS = (
    "v_template", "shapedirs", "posedirs", "j_regressor", "lbs_weights", "faces",
    "extra_joint_vertex_ids", "j_regressor_extra", "j_regressor_cocoplus", "j_regressor_h36m",
)


@dataclass
class SMPLModel:
    """SMPL arrays on one device, plus the layouts derived from them that the
    vertex kernels and the joint regression read (built once, in
    __post_init__)."""

    v_template: torch.Tensor       # (V, 3)
    shapedirs: torch.Tensor        # (V, 3, num_betas)
    posedirs: torch.Tensor         # (207, V*3), (vertex, channel)-major columns
    j_regressor: torch.Tensor      # (24, V)
    lbs_weights: torch.Tensor      # (V, 24)
    faces: torch.Tensor            # (F, 3) int64
    extra_joint_vertex_ids: torch.Tensor  # (21,) int64
    j_regressor_extra: Optional[torch.Tensor] = None     # (9, V)
    j_regressor_cocoplus: Optional[torch.Tensor] = None  # (19, V)
    j_regressor_h36m: Optional[torch.Tensor] = None      # (17, V)

    v_template_cm: torch.Tensor = field(init=False, repr=False)   # (3, V)
    shapedirs_cm: torch.Tensor = field(init=False, repr=False)    # (NB, 3, V)
    posedirs_cm: torch.Tensor = field(init=False, repr=False)     # (207, 3, V)
    joints_template: torch.Tensor = field(init=False, repr=False)  # (24, 3)
    joints_shapedirs: torch.Tensor = field(init=False, repr=False)  # (24, 3, NB)
    landmark_regressor: torch.Tensor = field(init=False, repr=False)  # (66, V)

    def __post_init__(self):
        v = self.num_verts
        self.v_template_cm = self.v_template.T.contiguous()
        self.shapedirs_cm = self.shapedirs.permute(2, 1, 0).contiguous()
        self.posedirs_cm = self.posedirs.reshape(-1, v, 3).transpose(1, 2).contiguous()
        # Rest joints without v_shaped: j_reg @ (vt + sd·β) = j_reg @ vt + (j_reg @ sd)·β.
        self.joints_template = self.j_regressor @ self.v_template
        self.joints_shapedirs = torch.einsum("jv,vcl->jcl", self.j_regressor, self.shapedirs)
        rows = [torch.zeros((21, v), dtype=self.v_template.dtype, device=self.v_template.device)]
        rows[0][torch.arange(21), self.extra_joint_vertex_ids] = 1.0
        for reg in (self.j_regressor_extra, self.j_regressor_cocoplus, self.j_regressor_h36m):
            if reg is not None:
                rows.append(reg)
        self.landmark_regressor = torch.cat(rows, dim=0)

    @property
    def num_verts(self) -> int:
        return self.v_template.shape[0]

    @property
    def num_betas(self) -> int:
        return self.shapedirs.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.v_template.device

    def to(self, device="cuda") -> "SMPLModel":
        """A copy on `device` (default CUDA; raises if CUDA is unavailable)."""
        device = resolve_device(device)
        return SMPLModel(
            **{
                f.name: None if getattr(self, f.name) is None else getattr(self, f.name).to(device)
                for f in fields(self)
                if f.init
            }
        )


def smpl_from_numpy(arrays: dict, device="cuda") -> SMPLModel:
    """SMPLModel from numpy arrays named as SMPLModel's fields (floats as
    float32, indices as int64), e.g. the fields of a JAX SMPLModel."""
    device = resolve_device(device)
    out = {}
    for name in _ARRAY_FIELDS:
        a = arrays.get(name)
        if a is None:
            out[name] = None
            continue
        dtype = torch.int64 if name in ("faces", "extra_joint_vertex_ids") else torch.float32
        out[name] = torch.from_numpy(np.array(a)).to(device=device, dtype=dtype)
    return SMPLModel(**out)


def convert_smpl_pkl(pkl_path: str, npz_path: str):
    """Convert an SMPL .pkl (neutral, male or female) into the .npz that
    load_smpl_npz reads: float64 arrays with a dense J_regressor, posedirs
    reshaped from (V, 3, 207) to (207, V·3), faces as int64.  The same file
    as the JAX package's converter writes.  Pickles run code when loaded:
    convert only files you trust."""
    with open(pkl_path, "rb") as f:
        data = pickle.load(f, encoding="latin1")

    def arr(x):
        return np.array(x, dtype=np.float64)

    j_reg = data["J_regressor"]
    if hasattr(j_reg, "toarray"):  # scipy.sparse
        j_reg = j_reg.toarray()
    posedirs = arr(data["posedirs"])  # (V, 3, 207)
    posedirs = posedirs.reshape(-1, posedirs.shape[-1]).T  # (207, V*3)
    np.savez(
        npz_path,
        v_template=arr(data["v_template"]),
        shapedirs=arr(data["shapedirs"]),
        posedirs=posedirs,
        J_regressor=arr(j_reg),
        weights=arr(data["weights"]),
        f=np.array(data["f"], np.int64),
    )


def load_smpl_npz(path: str, regressor_paths: Optional[dict] = None, device="cuda") -> SMPLModel:
    """Load a converted SMPL .npz (as convert_smpl_pkl writes it)."""
    data = np.load(path)
    extra = {}
    for name, p in (regressor_paths or {}).items():
        if p is not None and os.path.exists(p):
            extra[name] = np.load(p).astype(np.float32)
    return smpl_from_numpy(
        {
            "v_template": data["v_template"].astype(np.float32),
            "shapedirs": data["shapedirs"].astype(np.float32)[..., :10],
            "posedirs": data["posedirs"].astype(np.float32),
            "j_regressor": data["J_regressor"].astype(np.float32),
            "lbs_weights": data["weights"].astype(np.float32),
            "faces": data["f"],
            "extra_joint_vertex_ids": np.array(_EXTRA_VERTEX_IDS, np.int64),
            "j_regressor_extra": extra.get("extra"),
            "j_regressor_cocoplus": extra.get("cocoplus"),
            "j_regressor_h36m": extra.get("h36m"),
        },
        device=device,
    )


def _dp_coherent_vertices(v: int, rng) -> "np.ndarray | None":
    """Vertex positions that respect the DensePose mesh connectivity: random
    positions Laplacian-smoothed over the DensePose edge graph onto an
    ellipsoid (V=6890 only; None elsewhere or without UV_Processed.mat).
    Draws from `rng` exactly as the JAX package does."""
    if v != 6890:
        return None
    try:
        dp = load_densepose_uv_host(None)
    except OSError:
        return None
    tri = dp["vertex_map"][dp["faces"]]  # (F, 3) smpl-vertex ids
    e0 = np.concatenate([tri[:, 0], tri[:, 1], tri[:, 2], tri[:, 1], tri[:, 2], tri[:, 0]])
    e1 = np.concatenate([tri[:, 1], tri[:, 2], tri[:, 0], tri[:, 0], tri[:, 1], tri[:, 2]])
    deg = np.maximum(np.bincount(e0, minlength=v).astype(np.float64), 1.0)[:, None]
    pos = rng.normal(size=(v, 3))
    for _ in range(80):
        gathered = pos[e1]
        acc = np.stack(
            [np.bincount(e0, weights=gathered[:, c], minlength=v) for c in range(3)], axis=1
        )
        pos = acc / deg
        pos -= pos.mean(0)
        pos /= np.maximum(np.linalg.norm(pos, axis=1, keepdims=True), 1e-9)
    return pos * np.array([0.35, 0.75, 0.25])


def _convex_rows(rng, rows: int, cols: int) -> np.ndarray:
    w = np.exp(rng.normal(scale=2.0, size=(rows, cols)))
    return w / w.sum(axis=1, keepdims=True)


def synthetic_smpl(num_verts: int = 128, num_betas: int = 10, seed: int = 0, device="cuda") -> SMPLModel:
    """Deterministic synthetic SMPL-structured model, array for array the
    JAX package's synthetic_smpl for the same arguments (the real SMPL files
    are licensed downloads).  At 6890 vertices the template is a smooth
    ellipsoid embedding of the DensePose connectivity."""
    rng = np.random.default_rng(seed)
    v = num_verts
    joints = rng.normal(scale=0.3, size=(NUM_SMPL_JOINTS, 3))
    verts = _dp_coherent_vertices(v, rng)
    if verts is None:
        verts = joints[rng.integers(0, NUM_SMPL_JOINTS, v)] + rng.normal(scale=0.05, size=(v, 3))
    else:
        joints = verts[rng.integers(0, v, NUM_SMPL_JOINTS)] * 0.6
    d2 = ((verts[:, None] - joints[None]) ** 2).sum(-1)
    w = np.exp(-d2 / 0.01)
    j_reg = (w / w.sum(0, keepdims=True)).T
    lbs_w = w / w.sum(1, keepdims=True)
    faces = rng.integers(0, v, size=(2 * v, 3))
    f32 = np.float32
    return smpl_from_numpy(
        {
            "v_template": verts.astype(f32),
            "shapedirs": rng.normal(scale=0.01, size=(v, 3, num_betas)).astype(f32),
            "posedirs": rng.normal(scale=0.001, size=(23 * 9, v * 3)).astype(f32),
            "j_regressor": j_reg.astype(f32),
            "lbs_weights": lbs_w.astype(f32),
            "faces": faces,
            "extra_joint_vertex_ids": np.array(_EXTRA_VERTEX_IDS, np.int64) % v,
            "j_regressor_extra": _convex_rows(rng, 9, v).astype(f32),
            "j_regressor_cocoplus": _convex_rows(rng, 19, v).astype(f32),
            "j_regressor_h36m": _convex_rows(rng, 17, v).astype(f32),
        },
        device=device,
    )


def _mat3mul(a, b):
    return torch.sum(a[..., :, :, None] * b[..., None, :, :], dim=-2)


def _mat3vec(a, v):
    return torch.sum(a * v[..., None, :], dim=-1)


def _rigid_transform_chain(rot_mats, joints):
    """Forward-kinematic chain.

    :param rot_mats: (B, 24, 3, 3); :param joints: (B, 24, 3) rest joints.
    :return: (posed_joints (B,24,3), world_R (B,24,3,3), rel_t (B,24,3)), with
        rel_t the translation of the LBS-relative transforms.
    """
    world_r = [rot_mats[:, 0]]
    world_t = [joints[:, 0]]
    for j in range(1, NUM_SMPL_JOINTS):
        p = SMPL_PARENTS[j]
        world_r.append(_mat3mul(world_r[p], rot_mats[:, j]))
        world_t.append(_mat3vec(world_r[p], joints[:, j] - joints[:, p]) + world_t[p])
    world_r = torch.stack(world_r, dim=1)
    world_t = torch.stack(world_t, dim=1)
    return world_t, world_r, world_t - _mat3vec(world_r, joints)


def _kernel_inputs(model: SMPLModel, betas, body_pose, global_orient):
    """(posed_joints, a12 (B,24,12), pose_feature (B,207)) for the vertex
    kernels."""
    b = betas.shape[0]
    rot_mats = torch.cat([global_orient[:, None], body_pose], dim=1)  # (B,24,3,3)
    joints_rest = model.joints_template + torch.einsum("bl,jcl->bjc", betas, model.joints_shapedirs)
    eye = torch.eye(3, dtype=rot_mats.dtype, device=rot_mats.device)
    pose_feature = (rot_mats[:, 1:] - eye).reshape(b, -1)
    posed_joints, world_r, rel_t = _rigid_transform_chain(rot_mats, joints_rest)
    a12 = torch.cat([world_r.reshape(b, NUM_SMPL_JOINTS, 9), rel_t], dim=-1)
    return posed_joints, a12.contiguous(), pose_feature.contiguous()


def smpl_forward(model: SMPLModel, betas, body_pose, global_orient, pose2rot: bool = False):
    """SMPL forward pass.

    :param betas: (B, num_betas)
    :param body_pose: (B, 23, 3, 3) rotmats, or (B, 69) axis-angle if pose2rot
    :param global_orient: (B, 3, 3) rotmat, or (B, 3) axis-angle if pose2rot
    :return: dict with 'vertices' (B, V, 3), 'vertices_cm' (B, 3, V),
        'joints' (B, 90, 3) and 'smpl_joints' (B, 24, 3).
    """
    b = betas.shape[0]
    if pose2rot:
        body_pose = so3_exp(body_pose.reshape(b, 23, 3))
        global_orient = so3_exp(global_orient.reshape(b, 3))
    posed_joints, a12, pose_feature = _kernel_inputs(model, betas, body_pose, global_orient)
    verts_cm = cuda_lbs.smpl_verts_differentiable(
        a12, betas.contiguous(), pose_feature,
        model.v_template_cm, model.shapedirs_cm, model.posedirs_cm, model.lbs_weights,
    )
    regressed = torch.einsum("jv,bcv->bjc", model.landmark_regressor, verts_cm)
    return {
        "vertices": verts_cm.transpose(1, 2),
        "vertices_cm": verts_cm,
        "joints": torch.cat([posed_joints, regressed], dim=1),
        "smpl_joints": posed_joints,
    }


def smpl_vertex_moments(model: SMPLModel, betas, body_pose, global_orient, num_groups: int):
    """Per-group first and second vertex moments over sample batches.

    Inputs are flat (G·N, …) sample stacks, G = num_groups.  Returns
    (G, 2, 3, V): [:, 0] = Σ vertices, [:, 1] = Σ vertices² over each group's
    N samples, reduced inside kernel K1.
    """
    gn = betas.shape[0]
    if gn % num_groups:
        raise ValueError(f"batch {gn} is not a multiple of num_groups={num_groups}")
    n = gn // num_groups
    _, a12, pose_feature = _kernel_inputs(model, betas, body_pose, global_orient)
    return cuda_lbs.smpl_moments(
        a12.reshape(num_groups, n, NUM_SMPL_JOINTS, 12),
        betas.reshape(num_groups, n, -1).contiguous(),
        pose_feature.reshape(num_groups, n, -1),
        model.v_template_cm, model.shapedirs_cm, model.posedirs_cm, model.lbs_weights,
    )
