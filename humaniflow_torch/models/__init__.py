from .canny import CannyEdgeDetector
from .hrnet import PoseHighResolutionNet, get_kp_locations_confs_from_heatmaps
from .humaniflow import HumaniflowModel, immediate_parent_to_all_ancestors
from .resnet import RESNET_FEAT_DIMS, ResNet, resnet18, resnet50
from .smpl import (
    NUM_BODYPARTS,
    NUM_SMPL_JOINTS,
    SMPL_PARENTS,
    SMPLModel,
    convert_smpl_pkl,
    load_smpl_npz,
    smpl_forward,
    smpl_from_numpy,
    smpl_vertex_moments,
    synthetic_smpl,
)
from .vitpose import ViTPose

__all__ = [
    "CannyEdgeDetector",
    "HumaniflowModel",
    "NUM_BODYPARTS",
    "NUM_SMPL_JOINTS",
    "PoseHighResolutionNet",
    "RESNET_FEAT_DIMS",
    "ResNet",
    "SMPLModel",
    "SMPL_PARENTS",
    "ViTPose",
    "convert_smpl_pkl",
    "get_kp_locations_confs_from_heatmaps",
    "immediate_parent_to_all_ancestors",
    "load_smpl_npz",
    "resnet18",
    "resnet50",
    "smpl_forward",
    "smpl_from_numpy",
    "smpl_vertex_moments",
    "synthetic_smpl",
]
