"""Flow-prior-guided optimisation after inference (SMPLify-style refinement).

The PyTorch counterpart of `humaniflow_tpu/pipelines/optimise.py`
(reference `optimise/optimise_humaniflow.py`): plain SGD over (body pose
axis-angle, global axis-angle, shape, weak-perspective camera), initialised
from a prediction, on the loss

    J2D·w_j2d − pose flow log-prob·w_pose − shape Gaussian log-prob·w_shape,

where the priors are the image-conditioned distribution that the heads
predict from the cached encoder features (the encoder never reruns) and the
state's shape, pose and global rotation reach the pose prior through the
teacher-forced flow contexts as well as through the log-prob itself.

The loop has no host sync: the NaN guard is a device flag `halted`.  After
the first update that leaves a non-finite value (or comes from a non-finite
loss) the state and the reported losses stay frozen, as the JAX loop's
carried flag freezes them.  `final_losses` are the loss terms of the last
accepted iteration, evaluated at the state *before* its update, as JAX
reports them; `initial_losses` those of the initial state.  SMPL runs
through kernel K2 with its gradient (models/cuda_lbs.py `SMPLVerts`).
"""

import math
from typing import Dict

import numpy as np
import torch

from ..configs.defaults import OptimiseConfig
from ..data.label_conversions import ALL_JOINTS_TO_COCO_MAP
from ..metrics.train_metrics import undo_keypoint_normalisation
from ..models.humaniflow import HumaniflowModel
from ..models.resnet import fp32_convolutions
from ..models.smpl import SMPLModel, smpl_forward
from ..ops.camera import orthographic_project
from ..ops.so3 import so3_exp, so3_log
from ..utils.device import resolve_device

_STATE_KEYS = ("pose", "glob", "shape", "cam")


def make_optimise_fn(model: HumaniflowModel, smpl: SMPLModel, optimise_cfg: OptimiseConfig, img_wh: int = 256,
                     device=None):
    """The refinement closure `fn(init) -> dict`; see
    optimise_batch_with_humaniflow_prior for the contract.

    :param device: default CUDA (raises if unavailable); model and smpl must
        already live there.
    """
    device = resolve_device(device)
    for name, dev in (("model", model.device), ("smpl", smpl.device)):
        if dev.type != device.type or (device.index is not None and dev.index != device.index):
            raise ValueError(f"{name} lives on {dev}, not on {device}")
    flip = so3_exp(torch.tensor([[math.pi, 0.0, 0.0]], device=device))[0]
    w = optimise_cfg.LOSS_WEIGHTS
    lr = optimise_cfg.LR

    def loss_fn(state, input_feats, target_j2d, vis):
        b = state["shape"].shape[0]
        pose_r = so3_exp(state["pose"].reshape(b, 23, 3))
        glob_r = so3_exp(state["glob"])
        joints = smpl_forward(smpl, state["shape"], pose_r, glob_r)["joints"][:, ALL_JOINTS_TO_COCO_MAP]
        # the 3D joints are y-up: flip about x before projecting
        joints = torch.einsum("ij,bkj->bki", flip, joints)
        j2d = undo_keypoint_normalisation(orthographic_project(joints, state["cam"]), img_wh)
        se = torch.sum((target_j2d - j2d) ** 2, dim=-1)
        joints2d_loss = torch.sum(se * vis) / torch.clamp(torch.sum(vis) * 2.0, min=1.0)

        head = model.apply(
            None, input_feats=input_feats, compute_point_est=False, compute_for_loglik=True,
            shape_for_loglik=state["shape"], pose_R_for_loglik=pose_r, glob_R_for_loglik=glob_r,
        )
        pose_logprob = torch.sum(model.pose_log_prob(pose_r, head["pose_flow_contexts_for_loglik"])) / b
        mode, log_std = head["shape_mode"], head["shape_log_std"]
        shape_lp = -0.5 * ((state["shape"] - mode) ** 2) / torch.exp(2.0 * log_std) - log_std \
            - 0.5 * math.log(2 * math.pi)
        shape_logprob = torch.sum(shape_lp) / b
        total = joints2d_loss * w.JOINTS2D - pose_logprob * w.POSE_PRIOR - shape_logprob * w.SHAPE_PRIOR
        return total, {"joints2D": joints2d_loss, "pose_logprob": pose_logprob, "shape_logprob": shape_logprob}

    def step(state, halted, aux, input_feats, target_j2d, vis):
        """One SGD step with the freeze; no host sync."""
        leaves = {k: state[k].detach().requires_grad_(True) for k in _STATE_KEYS}
        with torch.enable_grad(), fp32_convolutions():
            loss, aux_new = loss_fn(leaves, input_feats, target_j2d, vis)
            grads = torch.autograd.grad(loss, [leaves[k] for k in _STATE_KEYS])
        with torch.no_grad():
            new = {k: state[k] - lr * g for k, g in zip(_STATE_KEYS, grads)}
            finite = torch.isfinite(loss)
            for v in new.values():
                finite = finite & torch.isfinite(v).all()
            use_new = finite & ~halted
            state = {k: torch.where(use_new, new[k], state[k]) for k in _STATE_KEYS}
            aux = {k: torch.where(use_new, aux_new[k].detach(), aux[k]) for k in aux}
        return state, halted | ~finite, aux

    def fn(init: Dict) -> Dict:
        # copies: the state must take gradients even when init holds inference
        # tensors (predict's outputs are made under torch.inference_mode)
        as_t = lambda a: torch.as_tensor(np.asarray(a) if not isinstance(a, torch.Tensor) else a,  # noqa: E731
                                         dtype=torch.float32, device=device).clone()
        b = init["shape"].shape[0]
        glob = as_t(init["glob_axisangle"]) if "glob_axisangle" in init else so3_log(as_t(init["glob_rotmat"]))
        state = {
            "pose": as_t(init["pose_axisangle"]).reshape(b, 23 * 3),
            "glob": glob,
            "shape": as_t(init["shape"]),
            "cam": as_t(init["cam_wp"]),
        }
        vis = as_t(init["joints2D_conf"]) > optimise_cfg.JOINTS2D_VISIB_THRESHOLD
        vis[:, :7] = True  # torso and head joints are always kept
        vis = vis.to(torch.float32)
        input_feats, target_j2d = as_t(init["input_feats"]), as_t(init["joints2D"])
        with torch.no_grad():
            _, aux0 = loss_fn(state, input_feats, target_j2d, vis)
        halted = torch.zeros((), dtype=torch.bool, device=device)
        aux = dict(aux0)
        for _ in range(optimise_cfg.NUM_ITERS):
            state, halted, aux = step(state, halted, aux, input_feats, target_j2d, vis)
        return {
            "pose_axisangle": state["pose"].reshape(b, 23, 3),
            "glob_axisangle": state["glob"],
            "shape": state["shape"],
            "cam_wp": state["cam"],
            "halted_on_nan": halted,
            "initial_losses": aux0,
            "final_losses": aux,
        }

    return fn


def optimise_batch_with_humaniflow_prior(model: HumaniflowModel, smpl: SMPLModel, optimise_cfg: OptimiseConfig,
                                         init: Dict, img_wh: int = 256, device=None) -> Dict:
    """Refine SMPL parameters against 2D joints with the flow prior.

    One-shot wrapper over make_optimise_fn; a caller looping over batches
    may build the closure once instead.

    :param init: tensors or numpy arrays: shape (B, nb), pose_axisangle
        (B, 23, 3), glob_rotmat (B, 3, 3) or glob_axisangle (B, 3), cam_wp
        (B, 3), input_feats (B, F), joints2D (B, 17, 2) target pixels,
        joints2D_conf (B, 17).
    :param device: default CUDA; raises if CUDA is unavailable.
    :return: pose_axisangle (B, 23, 3), glob_axisangle (B, 3), shape,
        cam_wp, halted_on_nan (a bool tensor), initial_losses and
        final_losses ({"joints2D", "pose_logprob", "shape_logprob"}), all
        device tensors.
    """
    return make_optimise_fn(model, smpl, optimise_cfg, img_wh, device=device)(init)
