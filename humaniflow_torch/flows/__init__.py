from .dense_nn import DenseNN
from .factory import ConditionalFlow, create_conditional_norm_flow
from .so3_flow import SO3FlowDistribution
from .spline import monotonic_rational_spline_forward, monotonic_rational_spline_inverse
from .transforms import ConditionalSplineCoupling, Permute, ScaledRadialTanh

__all__ = [
    "ConditionalFlow",
    "ConditionalSplineCoupling",
    "DenseNN",
    "Permute",
    "SO3FlowDistribution",
    "ScaledRadialTanh",
    "create_conditional_norm_flow",
    "monotonic_rational_spline_forward",
    "monotonic_rational_spline_inverse",
]
