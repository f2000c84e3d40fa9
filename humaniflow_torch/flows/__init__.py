from .autoregressive import MADE, ConditionalAffineAutoregressive, ConditionalSplineAutoregressive, FlowBatchNorm
from .dense_nn import DenseNN
from .factory import ConditionalFlow, create_conditional_norm_flow
from .so3_flow import SO3FlowDistribution
from .spline import monotonic_rational_spline, monotonic_rational_spline_forward, monotonic_rational_spline_inverse
from .transforms import (
    ConditionalAdditiveCoupling,
    ConditionalAffineCoupling,
    ConditionalLinearPLU,
    ConditionalSplineCoupling,
    LinearPLU,
    Permute,
    RadialTanh,
    ScaledRadialTanh,
)

__all__ = [
    "ConditionalAdditiveCoupling",
    "ConditionalAffineAutoregressive",
    "ConditionalAffineCoupling",
    "ConditionalFlow",
    "ConditionalLinearPLU",
    "ConditionalSplineAutoregressive",
    "ConditionalSplineCoupling",
    "DenseNN",
    "FlowBatchNorm",
    "LinearPLU",
    "MADE",
    "Permute",
    "RadialTanh",
    "SO3FlowDistribution",
    "ScaledRadialTanh",
    "create_conditional_norm_flow",
    "monotonic_rational_spline",
    "monotonic_rational_spline_forward",
    "monotonic_rational_spline_inverse",
]
