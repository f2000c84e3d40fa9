from .canny import CannyEdgeDetector
from .hrnet import PoseHighResolutionNet, get_kp_locations_confs_from_heatmaps
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
    "PoseHighResolutionNet",
    "SMPLModel",
    "get_kp_locations_confs_from_heatmaps",
    "load_smpl_npz",
    "resnet18",
    "resnet50",
    "smpl_forward",
    "smpl_from_numpy",
    "smpl_vertex_moments",
    "synthetic_smpl",
]
