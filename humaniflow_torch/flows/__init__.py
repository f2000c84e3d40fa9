from .dense_nn import DenseNN
from .factory import ConditionalFlow, create_conditional_norm_flow
from .spline import monotonic_rational_spline_forward
from .transforms import ConditionalSplineCoupling, Permute, ScaledRadialTanh

__all__ = [
    "ConditionalFlow",
    "ConditionalSplineCoupling",
    "DenseNN",
    "Permute",
    "ScaledRadialTanh",
    "create_conditional_norm_flow",
    "monotonic_rational_spline_forward",
]
