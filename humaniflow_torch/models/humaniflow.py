"""HumaniflowModel: ResNet encoder, shape / global-rotation / camera heads
and ancestor-conditioned SO(3) flows over the 23 body parts.

The PyTorch counterpart of `humaniflow_tpu/models/humaniflow.py`.  Parts
are grouped by kinematic-tree depth, so the autoregressive pass is 8 part-
batched flow evaluations; each part's flow and context weights sit on a
leading part axis and a level selects its rows by index.  Sampling draws
from an explicit torch.Generator, or takes the base noise from the caller
(`base_noise`), so that tests can feed the port the numbers JAX drew.

Training: `apply(train=True)` runs the encoder's BatchNorm on batch
statistics and updates its running ones in place (flax's update, see
models/resnet.py::BatchNorm); `compute_for_loglik` gives the teacher-forced
flow contexts of all 23 parts, scored by `pose_log_prob`; with flow
BatchNorm layers, `update_pose_flow_batchnorm_stats` moves their running
statistics after the optimizer's step.
"""

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.defaults import ModelConfig
from ..flows import cuda_level
from ..flows.factory import ConditionalFlow, create_conditional_norm_flow
from ..flows.so3_flow import SO3FlowDistribution
from ..ops.rotation import rot6d_to_rotmat
from ..ops.so3 import so3_exp, so3_log
from ..utils.device import resolve_device
from ..utils.tracing import span
from .resnet import RESNET_FEAT_DIMS, resnet18, resnet50
from .smpl import SMPL_PARENTS

INIT_CAM = (0.9, 0.0, 0.0)  # orthographic scale init
INIT_GLOB_6D = (1.0, 0.0, 0.0, 1.0, 0.0, 0.0)  # rotmat_to_rot6d(I)


def immediate_parent_to_all_ancestors(parents) -> Dict[int, List[int]]:
    """Per-bodypart ordered ancestor lists, excluding the root (bodypart i is
    SMPL joint i+1)."""
    ancestors: Dict[int, List[int]] = {}
    for i in range(1, len(parents)):
        part = i - 1
        parent = parents[i] - 1
        ancestors[part] = ([parent] + ancestors[parent]) if parent >= 0 else []
    return ancestors


class HumaniflowModel(nn.Module):
    """The model.  `apply(proxy, num_samples=N, ...)` runs the forward pass
    with the same options and outputs as the JAX model's `apply` (it takes
    the place of nn.Module.apply, which this model does not use)."""

    def __init__(
        self,
        cfg: ModelConfig,
        smpl_parents: Sequence[int] = SMPL_PARENTS,
        device=None,
        generator: Optional[torch.Generator] = None,
    ):
        """:param device: default CUDA; raises if CUDA is unavailable.
        :param generator: CPU generator for the random init (seed 0 if None)."""
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.ancestors = immediate_parent_to_all_ancestors(tuple(smpl_parents))
        self.num_bodyparts = len(self.ancestors)
        self.max_ancestors = max(len(a) for a in self.ancestors.values())
        by_depth: Dict[int, List[int]] = {}
        for part, anc in self.ancestors.items():
            by_depth.setdefault(len(anc), []).append(part)
        self.levels: List[Tuple[int, ...]] = [tuple(sorted(by_depth[d])) for d in sorted(by_depth)]
        for li, parts in enumerate(self.levels):
            self.register_buffer(f"level_parts_{li}", torch.tensor(parts), persistent=False)

        idx = torch.zeros((self.num_bodyparts, self.max_ancestors), dtype=torch.long)
        mask = torch.zeros((self.num_bodyparts, self.max_ancestors))
        for part, anc in self.ancestors.items():
            idx[part, : len(anc)] = torch.tensor(anc, dtype=torch.long)
            mask[part, : len(anc)] = 1.0
        self.register_buffer("all_parts", torch.arange(self.num_bodyparts), persistent=False)
        self.register_buffer("anc_idx", idx, persistent=False)
        self.register_buffer("anc_mask", mask, persistent=False)
        self.register_buffer("init_cam", torch.tensor(INIT_CAM), persistent=False)
        self.register_buffer("init_glob", torch.tensor(INIT_GLOB_6D), persistent=False)

        nf = cfg.NORM_FLOW
        self.flow: ConditionalFlow = create_conditional_norm_flow(
            event_dim=3,
            context_dim=nf.CONTEXT_DIM,
            num_transforms=nf.NUM_TRANSFORMS,
            num_parts=self.num_bodyparts,
            transform_type=nf.TRANSFORM_TYPE,
            transform_hidden_dims=nf.TRANSFORM_NN_HIDDEN_DIMS,
            permute_type=nf.PERMUTE_TYPE,
            permute_hidden_dims=nf.PERMUTE_NN_HIDDEN_DIMS,
            batch_norm=nf.BATCH_NORM,
            radial_tanh_radius=nf.COMPACT_SUPPORT_RADIUS,
            base_dist_std=nf.BASE_DIST_STD,
            count_bins=nf.NUM_SPLINE_SEGMENTS,
            bound=nf.COMPACT_SUPPORT_RADIUS,
        )
        self.so3_dist = SO3FlowDistribution(self.flow, support_radius=nf.COMPACT_SUPPORT_RADIUS)

        build = resnet18 if cfg.NUM_RESNET_LAYERS == 18 else resnet50
        self.encoder = build(cfg.NUM_IN_CHANNELS)
        self.feat_dim = RESNET_FEAT_DIMS[cfg.NUM_RESNET_LAYERS]
        fc1_dim = 512 if cfg.NUM_RESNET_LAYERS == 18 else 1024
        self.isgc_dim = cfg.INPUT_SHAPE_GLOB_CAM_FEATS_DIM
        n_betas = cfg.NUM_SMPL_BETAS
        self.fc1 = nn.Linear(self.feat_dim, fc1_dim)
        self.fc_shape = nn.Linear(fc1_dim, n_betas * 2)
        self.fc_glob = nn.Linear(fc1_dim, 6)
        self.fc_cam = nn.Linear(fc1_dim, 3)
        self.fc_isgc = nn.Linear(self.feat_dim + n_betas + 9 + 3, self.isgc_dim)
        ctx_in = self.isgc_dim + 9 * self.max_ancestors
        self.fc_flow_context_weight = nn.Parameter(torch.empty(self.num_bodyparts, nf.CONTEXT_DIM, ctx_in))
        self.fc_flow_context_bias = nn.Parameter(torch.empty(self.num_bodyparts, nf.CONTEXT_DIM))

        self.reset_parameters(generator if generator is not None else torch.Generator().manual_seed(0))
        self.eval()
        self.to(device)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator):
        """Random init from `generator`: LeCun-normal convs, identity
        BatchNorm, U(±1/√fan_in) dense layers (torch.nn.Linear's default)."""
        self.encoder.reset_parameters(generator)
        dense = [(m.weight, m.bias) for m in self.modules() if isinstance(m, nn.Linear)]
        dense.append((self.fc_flow_context_weight, self.fc_flow_context_bias))
        for w, b in dense:
            bound = w.shape[-1] ** -0.5
            w.uniform_(-bound, bound, generator=generator)
            b.uniform_(-bound, bound, generator=generator)
        for t in self.flow.transforms:
            if hasattr(t, "reset_parameters"):
                t.reset_parameters(generator)

    @property
    def device(self) -> torch.device:
        return self.fc1.weight.device

    # ------------------------------------------------------------- internals
    def _isgc_feats(self, input_feats, shape, glob_r, cam):
        """Input/shape/glob/cam features; shape may carry a samples axis
        (B, N, nb), the other arguments are (B, ...)."""
        if shape.dim() == 3:
            b, n = shape.shape[:2]
            feats = torch.cat(
                [
                    input_feats[:, None].expand(b, n, self.feat_dim),
                    shape,
                    glob_r.reshape(b, 1, 9).expand(b, n, 9),
                    cam[:, None].expand(b, n, 3),
                ],
                dim=-1,
            )
        else:
            feats = torch.cat([input_feats, shape, glob_r.reshape(-1, 9), cam], dim=-1)
        return F.elu(self.fc_isgc(feats))

    def _part_contexts(self, parts, isgc, rot_buf):
        """Flow contexts (..., P, ctx) of the parts `parts` (LongTensor (P,))
        given isgc (..., isgc_dim) and the rotation buffer (..., 23, 3, 3)."""
        buf = rot_buf.reshape(rot_buf.shape[:-3] + (self.num_bodyparts, 9))
        anc = buf[..., self.anc_idx[parts], :] * self.anc_mask[parts][..., None]  # (..., P, A, 9)
        anc = anc.reshape(anc.shape[:-2] + (9 * self.max_ancestors,))
        isgc_b = isgc[..., None, :].expand(anc.shape[:-1] + (self.isgc_dim,))
        ctx_in = torch.cat([isgc_b, anc], dim=-1)
        ctx = torch.einsum("...pi,poi->...po", ctx_in, self.fc_flow_context_weight[parts])
        return F.elu(ctx + self.fc_flow_context_bias[parts])

    def _fused_level_enabled(self) -> bool:
        """Whether the autoregressive pass routes each level's flow forward
        through the fused level kernel K5 (flows/cuda_level.py): exactly
        when grad mode is off, as under the predict and evaluate entries'
        inference_mode, and `supports_flow` accepts the flow (its structure
        and every limit of the kernel).  K5 has no backward, so a forward
        under grad runs eager, as does a flow the kernel does not take.
        This is the one place the route is decided; eager PyTorch has no
        trace, so grad mode is read on every call.  On CUDA the fused route
        launches K5; on the CPU its plain twin runs, the same `self.flow`
        call as the eager route, as the JAX package runs the Pallas kernel
        in interpret mode off the TPU."""
        return not torch.is_grad_enabled() and cuda_level.supports_flow(self.flow)

    def _autoregress(self, isgc, level_noise=None, zero_sample0=False):
        """Depth-level autoregressive pass.

        :param isgc: (..., isgc_dim), batch shape (B,) or (B, S).
        :param level_noise: None for the flow mode (point estimate), else one
            unscaled standard-normal tensor per level, (..., P, 3), or with
            zero_sample0 (B, S-1, P, 3): sample 0 then gets zero noise, so its
            trajectory is the flow mode.
        :return: (pose_so3 (..., 23, 3), pose_SO3 (..., 23, 3, 3))
        """
        fused = self._fused_level_enabled()
        with span("flow.sample"):
            batch_shape = isgc.shape[:-1]
            so3_buf = isgc.new_zeros(batch_shape + (self.num_bodyparts, 3))
            rot_buf = isgc.new_zeros(batch_shape + (self.num_bodyparts, 3, 3))
            for li in range(len(self.levels)):
                with span("flow.level"):
                    parts = getattr(self, f"level_parts_{li}")
                    ctx = self._part_contexts(parts, isgc, rot_buf)
                    if level_noise is None:
                        z = ctx.new_zeros(ctx.shape[:-1] + (3,))
                    else:
                        noise = level_noise[li]
                        if zero_sample0:
                            noise = torch.cat([torch.zeros_like(noise[:, :1]), noise], dim=1)
                        z = noise * self.flow.base_dist_std
                    if fused:  # the einsum in _part_contexts may leave ctx strided
                        x = cuda_level.flow_forward_level(self.flow, z.contiguous(), ctx.contiguous(), parts)
                    else:
                        x = self.flow(z, ctx, parts)
                    so3_buf[..., parts, :] = x
                    rot_buf[..., parts, :, :] = so3_exp(x)
        return so3_buf, rot_buf

    def _draw_level_noise(self, batch_shape, generator):
        return [
            torch.randn(
                tuple(batch_shape) + (len(parts), 3), generator=generator, device=self.device
            )
            for parts in self.levels
        ]

    def draw_noise(self, b: int, num_samples: int, generator: torch.Generator, use_shape_mode_for_samples: bool):
        """(shape_noise (b, N, nb) or None, base_noise [per level (b, N, P, 3)])
        drawn from `generator` in the order in which apply draws them for a
        batch of b (parallel ranks draw the whole batch's noise and keep their
        block)."""
        shape_noise = None
        if not use_shape_mode_for_samples:
            shape_noise = torch.randn((b, num_samples, self.cfg.NUM_SMPL_BETAS), generator=generator,
                                      device=self.device)
        return shape_noise, self._draw_level_noise((b, num_samples), generator)

    # --------------------------------------------------------------- forward
    def apply(
        self,
        proxy_input: Optional[torch.Tensor] = None,
        *,
        generator: Optional[torch.Generator] = None,
        compute_point_est: bool = True,
        num_samples: int = 0,
        use_shape_mode_for_samples: bool = False,
        compute_for_loglik: bool = False,
        shape_for_loglik: Optional[torch.Tensor] = None,
        pose_R_for_loglik: Optional[torch.Tensor] = None,
        glob_R_for_loglik: Optional[torch.Tensor] = None,
        input_feats: Optional[torch.Tensor] = None,
        grad_for_pose_point_est: bool = False,
        return_input_feats: bool = False,
        train: bool = False,
        base_noise: Optional[List[torch.Tensor]] = None,
        shape_noise: Optional[torch.Tensor] = None,
    ):
        """Forward pass.

        :param proxy_input: (B, H, W, 18) NHWC proxy representation.
        :param generator: draws the sampling noise (on the model's device)
            unless base_noise / shape_noise give it.
        :param compute_for_loglik: also return the teacher-forced flow
            contexts of all 23 parts, 'pose_flow_contexts_for_loglik'
            (B, 23, ctx), given the target shape (B, nb), body rotations
            (B, 23, 3, 3) and global rotation (B, 3, 3); score them with
            `pose_log_prob`.
        :param grad_for_pose_point_est: keep the point estimate's gradient
            (by default it is detached, as in the JAX model).
        :param train: run the encoder's BatchNorm on batch statistics and
            update its running statistics (returned as
            'encoder_batch_stats', state_dict keys → copies); otherwise the
            encoder runs on its running statistics.
        :param base_noise: per depth level, unscaled standard-normal noise
            (B, num_samples, P_level, 3).
        :param shape_noise: (B, num_samples, num_betas) standard normal, used
            unless use_shape_mode_for_samples.
        :return: dict of predictions, keyed as the JAX model's.
        """
        out = {}
        if input_feats is None:
            was_training = self.encoder.training
            self.encoder.train(train)
            try:
                with span("encoder"):
                    input_feats = self.encoder(proxy_input)
            finally:
                self.encoder.train(was_training)
            if train:
                out["encoder_batch_stats"] = self.encoder_batch_stats()
        if return_input_feats:
            out["input_feats"] = input_feats

        with span("heads"):
            x = F.elu(self.fc1(input_feats))
            cam = self.fc_cam(x) + self.init_cam
            glob_r = rot6d_to_rotmat(self.fc_glob(x) + self.init_glob)
            n_betas = self.cfg.NUM_SMPL_BETAS
            shape_params = self.fc_shape(x)
            shape_mode = shape_params[:, :n_betas]
            shape_log_std = shape_params[:, n_betas:]
        out.update(cam_wp=cam, glob_rotmat=glob_r, shape_mode=shape_mode, shape_log_std=shape_log_std)

        b = shape_mode.shape[0]
        if num_samples > 0:
            if generator is None and (base_noise is None or (shape_noise is None and not use_shape_mode_for_samples)):
                raise ValueError("num_samples > 0 needs a generator or explicit noise")
            if use_shape_mode_for_samples:
                shape_samples = shape_mode[:, None].expand(b, num_samples, n_betas)
            else:
                if shape_noise is None:
                    shape_noise = torch.randn(
                        (b, num_samples, n_betas), generator=generator, device=self.device
                    )
                shape_samples = shape_mode[:, None] + shape_noise * torch.exp(shape_log_std)[:, None]
            out["shape_samples"] = shape_samples
            if base_noise is None:
                base_noise = self._draw_level_noise((b, num_samples), generator)

        if compute_point_est and num_samples > 0:
            # One (B, N+1) pass: sample 0 carries the shape mode and zero
            # noise, so its trajectory is the point estimate.
            shape_all = torch.cat([shape_mode[:, None], shape_samples], dim=1)
            isgc_all = self._isgc_feats(input_feats, shape_all, glob_r, cam)
            so3_all, rot_all = self._autoregress(isgc_all, base_noise, zero_sample0=True)
            so3_pe, rot_pe = so3_all[:, 0], rot_all[:, 0]
            if not grad_for_pose_point_est:
                so3_pe, rot_pe = so3_pe.detach(), rot_pe.detach()
            out["pose_axisangle_point_est"] = so3_pe
            out["pose_rotmats_point_est"] = rot_pe
            out["pose_rotmats_samples"] = rot_all[:, 1:]
        else:
            if compute_point_est:
                isgc_pe = self._isgc_feats(input_feats, shape_mode, glob_r, cam)
                so3_pe, rot_pe = self._autoregress(isgc_pe)
                if not grad_for_pose_point_est:
                    so3_pe, rot_pe = so3_pe.detach(), rot_pe.detach()
                out["pose_axisangle_point_est"] = so3_pe
                out["pose_rotmats_point_est"] = rot_pe
            if num_samples > 0:
                isgc_s = self._isgc_feats(input_feats, shape_samples, glob_r, cam)
                out["pose_rotmats_samples"] = self._autoregress(isgc_s, base_noise)[1]

        if compute_for_loglik:
            # teacher forcing: the ancestors are the targets, so all 23
            # parts' contexts come from one pass with no autoregression
            isgc_ll = self._isgc_feats(input_feats, shape_for_loglik, glob_R_for_loglik, cam)
            out["pose_flow_contexts_for_loglik"] = self._part_contexts(self.all_parts, isgc_ll, pose_R_for_loglik)
        return out

    def encoder_batch_stats(self) -> Dict[str, torch.Tensor]:
        """Copies of the encoder's BatchNorm running statistics, keyed as in
        the model's state_dict."""
        return {
            f"encoder.{k}": v.detach().clone()
            for k, v in self.encoder.state_dict().items()
            if k.endswith(("running_mean", "running_var"))
        }

    def pose_log_prob(self, pose_rotmats, contexts):
        """Per-part SO(3) log-likelihoods under the ancestor-conditioned flows.

        :param pose_rotmats: (B, 23, 3, 3) target rotations.
        :param contexts: (B, 23, ctx) from apply(compute_for_loglik=True).
        :return: (B, 23) log-probabilities.
        """
        return self.so3_dist.log_prob(pose_rotmats, contexts, self.all_parts)

    @torch.no_grad()
    def update_pose_flow_batchnorm_stats(self, pose_rotmats, contexts):
        """Move the flow BatchNorm layers' running statistics towards a
        training batch, in place (no-op unless NORM_FLOW.BATCH_NORM): the
        density-direction chain from the principal so(3) log-map branch of
        the targets, as the JAX model's update.

        :param pose_rotmats: (B, 23, 3, 3) target rotations.
        :param contexts: (B, 23, ctx) from apply(compute_for_loglik=True).
        """
        if self.flow.has_batch_norm:
            self.flow.update_batchnorm_stats(so3_log(pose_rotmats), contexts)
