from .canny import CannyEdgeDetector
from .humaniflow import HumaniflowModel
from .resnet import resnet18, resnet50
from .smpl import (
    SMPLModel,
    load_smpl_npz,
    smpl_forward,
    smpl_from_numpy,
    smpl_vertex_moments,
    synthetic_smpl,
)

__all__ = [
    "CannyEdgeDetector",
    "HumaniflowModel",
    "SMPLModel",
    "load_smpl_npz",
    "resnet18",
    "resnet50",
    "smpl_forward",
    "smpl_from_numpy",
    "smpl_vertex_moments",
    "synthetic_smpl",
]
