"""SO(3) pushforward of an so(3) ≅ R³ conditional flow: its log-density.

The PyTorch counterpart of `humaniflow_tpu/flows/so3_flow.py`.  A rotation
R has the preimages {log R} ∪ {log R shifted by ±2π along its axis} under
the exponential map; the three are scored by the flow in one pass along a
leading axis of size 3 and reduced with logsumexp.  Branches outside the
flow's compact support get the log-density _NEG_INF, and are zeroed before
the flow sees them, so that neither they nor their gradients can be NaN.
"""

import math

import torch

from ..ops.so3 import so3_log, so3_log_abs_det_jacobian, so3_xset
from .factory import ConditionalFlow

_NEG_INF = -1e30  # not -inf: a masked branch must not give NaN gradients through logsumexp


class SO3FlowDistribution:
    """Distribution over SO(3) = exp_*(flow over so(3) with compact support)."""

    def __init__(self, flow: ConditionalFlow, support_radius: float = 1.5 * math.pi):
        self.flow = flow
        self.support_radius = support_radius

    def log_prob(self, rotmat, context, parts):
        """log p(R | context).

        :param rotmat: (..., P, 3, 3); :param context: (..., P, C).
        :param parts: LongTensor (P,), the parts on the P axis.
        :return: (..., P) log-probabilities.
        """
        x = so3_log(rotmat)
        branches = torch.cat([x[None], so3_xset(x, 1)], dim=0)  # (3, ..., P, 3)
        in_support = torch.linalg.norm(branches, dim=-1) < self.support_radius
        safe = torch.where(in_support[..., None], branches, torch.zeros_like(branches))
        ctx = context[None].expand((3,) + context.shape)
        flow_lp = self.flow.log_prob(safe, ctx, parts)
        terms = torch.where(in_support, flow_lp - so3_log_abs_det_jacobian(safe), torch.full_like(flow_lp, _NEG_INF))
        return torch.logsumexp(terms, dim=0)
