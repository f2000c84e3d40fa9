"""Typed configuration tree with yaml-file and dotted-path CLI overrides.

The PyTorch package's own copy of `humaniflow_tpu/configs/defaults.py`:
same knobs and defaults, kept separate so that the port imports nothing of
the JAX package.  Keep the two files in step when a knob changes.
"""

import dataclasses
import math
from dataclasses import dataclass, field
from typing import List, Optional, Tuple


@dataclass
class NormFlowConfig:
    CONTEXT_DIM: int = 64
    NUM_TRANSFORMS: int = 2
    TRANSFORM_TYPE: str = "spline_coupling"  # spline_coupling | additive_coupling | affine_coupling
    TRANSFORM_NN_HIDDEN_DIMS: Tuple[int, ...] = (64, 32, 32)
    NUM_SPLINE_SEGMENTS: int = 8
    PERMUTE_TYPE: str = "permute"  # permute | conditional_linear_plu
    PERMUTE_NN_HIDDEN_DIMS: Optional[Tuple[int, ...]] = None
    # per-block BatchNorm flow layer (off by default, as in the reference
    # factory pyro_conditional_norm_flow.py:29); running stats EMA-update
    # during training via the train step (train_step.py)
    BATCH_NORM: bool = False
    COMPACT_SUPPORT_RADIUS: float = 1.5 * math.pi
    BASE_DIST_STD: float = 0.6


@dataclass
class ModelConfig:
    NUM_IN_CHANNELS: int = 18
    NUM_RESNET_LAYERS: int = 18
    INPUT_SHAPE_GLOB_CAM_FEATS_DIM: int = 256
    NUM_SMPL_BETAS: int = 10
    NORM_FLOW: NormFlowConfig = field(default_factory=NormFlowConfig)


@dataclass
class DataConfig:
    BBOX_THRESHOLD: float = 0.95
    BBOX_SCALE_FACTOR: float = 1.2
    PROXY_REP_SIZE: int = 256
    HEATMAP_GAUSSIAN_STD: float = 4.0
    EDGE_NMS: bool = True
    EDGE_THRESHOLD: float = 0.0
    EDGE_GAUSSIAN_STD: float = 1.0
    EDGE_GAUSSIAN_SIZE: int = 5


@dataclass
class SmplAugment:
    SHAPE_STD: float = 1.25


@dataclass
class CamAugment:
    XY_STD: float = 0.05
    DELTA_Z_RANGE: Tuple[float, float] = (-0.5, 0.5)


@dataclass
class BboxAugment:
    DELTA_SCALE_RANGE: Tuple[float, float] = (-0.3, 0.2)
    DELTA_CENTRE_RANGE: Tuple[float, float] = (-5, 5)


@dataclass
class RgbAugment:
    LIGHT_LOC_RANGE: Tuple[float, float] = (0.05, 3.0)
    LIGHT_AMBIENT_RANGE: Tuple[float, float] = (0.4, 0.8)
    LIGHT_DIFFUSE_RANGE: Tuple[float, float] = (0.4, 0.8)
    LIGHT_SPECULAR_RANGE: Tuple[float, float] = (0.0, 0.5)
    OCCLUDE_BOTTOM_PROB: float = 0.02
    OCCLUDE_TOP_PROB: float = 0.005
    OCCLUDE_VERTICAL_PROB: float = 0.05
    PIXEL_CHANNEL_NOISE: float = 0.2


@dataclass
class ProxyRepAugment:
    REMOVE_PARTS_CLASSES: Tuple[int, ...] = tuple(range(1, 25))
    REMOVE_PARTS_PROBS: Tuple[float, ...] = (
        0.1, 0.1, 0.1, 0.1, 0.1, 0.1, 0.05, 0.05, 0.05, 0.05, 0.1, 0.1,
        0.1, 0.1, 0.05, 0.05, 0.05, 0.05, 0.1, 0.1, 0.1, 0.1, 0.05, 0.05,
    )
    REMOVE_APPENDAGE_JOINTS_PROB: float = 0.5
    REMOVE_JOINTS_INDICES: Tuple[int, ...] = (7, 8, 9, 10, 13, 14, 15, 16)
    REMOVE_JOINTS_PROB: float = 0.1
    DELTA_J2D_DEV_RANGE: Tuple[float, float] = (-6, 6)
    JOINTS_TO_SWAP: Tuple[Tuple[int, int], ...] = ((5, 6), (11, 12))
    JOINTS_SWAP_PROB: float = 0.1
    OCCLUDE_BOX_DIM: int = 48
    OCCLUDE_BOX_PROB: float = 0.1
    OCCLUDE_BOTTOM_PROB: float = 0.02
    OCCLUDE_TOP_PROB: float = 0.005
    OCCLUDE_VERTICAL_PROB: float = 0.05
    EXTREME_CROP_PROB: float = 0.1


@dataclass
class AugmentConfig:
    SMPL: SmplAugment = field(default_factory=SmplAugment)
    CAM: CamAugment = field(default_factory=CamAugment)
    BBOX: BboxAugment = field(default_factory=BboxAugment)
    RGB: RgbAugment = field(default_factory=RgbAugment)
    PROXY_REP: ProxyRepAugment = field(default_factory=ProxyRepAugment)


@dataclass
class SynthDataConfig:
    FOCAL_LENGTH: float = 300.0
    MEAN_CAM_T: Tuple[float, float, float] = (0.0, -0.2, 2.5)
    AUGMENT: AugmentConfig = field(default_factory=AugmentConfig)


@dataclass
class TrainConfig:
    NUM_EPOCHS: int = 231
    BATCH_SIZE: int = 72
    LR: float = 0.0001
    EPOCHS_PER_SAVE: int = 5
    PIN_MEMORY: bool = True
    NUM_WORKERS: int = 2
    SYNTH_DATA: SynthDataConfig = field(default_factory=SynthDataConfig)


@dataclass
class LossWeights:
    POSE: float = 150.0
    SHAPE: float = 50.0
    JOINTS2D: float = 25000.0
    GLOB_ROTMATS: float = 5000.0
    VERTS3D: float = 0.0
    JOINTS3D: float = 0.0


@dataclass
class LossConfig:
    REDUCTION: str = "mean"
    J2D_LOSS_ON: str = "point_est+samples"
    NUM_J2D_SAMPLES: int = 8
    APPLY_POINT_EST_LOSS: bool = False
    WEIGHTS: LossWeights = field(default_factory=LossWeights)


@dataclass
class HumaniflowConfig:
    MODEL: ModelConfig = field(default_factory=ModelConfig)
    DATA: DataConfig = field(default_factory=DataConfig)
    TRAIN: TrainConfig = field(default_factory=TrainConfig)
    LOSS: LossConfig = field(default_factory=LossConfig)


@dataclass
class OptimiseLossWeights:
    JOINTS2D: float = 1.0
    POSE_PRIOR: float = 0.3
    SHAPE_PRIOR: float = 1.0


@dataclass
class OptimiseConfig:
    """reference: configs/optimise_config.py"""

    LR: float = 1e-4
    NUM_ITERS: int = 81
    JOINTS2D_VISIB_THRESHOLD: float = 0.75
    LOSS_WEIGHTS: OptimiseLossWeights = field(default_factory=OptimiseLossWeights)


def get_humaniflow_cfg_defaults() -> HumaniflowConfig:
    return HumaniflowConfig()


def get_optimise_cfg_defaults() -> OptimiseConfig:
    return OptimiseConfig()


# ---------------------------------------------------------------------------
# yaml / CLI override machinery (yacs merge_from_file / merge_from_list parity)
# ---------------------------------------------------------------------------

def _set_dotted(cfg, path: str, value):
    parts = path.split(".")
    obj = cfg
    for p in parts[:-1]:
        obj = getattr(obj, p)
    name = parts[-1]
    current = getattr(obj, name)
    if current is not None and not isinstance(current, (list, tuple, dict)):
        value = type(current)(value)
    elif isinstance(current, tuple) and isinstance(value, list):
        value = tuple(value)
    setattr(obj, name, value)


def apply_overrides(cfg, overrides: List):
    """yacs merge_from_list parity: ['TRAIN.LR', 1e-5, 'MODEL.X', 3, ...]."""
    assert len(overrides) % 2 == 0
    for key, value in zip(overrides[::2], overrides[1::2]):
        _set_dotted(cfg, key, value)
    return cfg


def _merge_dict(cfg, d: dict, prefix=""):
    for k, v in d.items():
        if isinstance(v, dict) and dataclasses.is_dataclass(getattr(cfg, k)):
            _merge_dict(getattr(cfg, k), v)
        else:
            _set_dotted(cfg, k, v)
    return cfg


def load_config(yaml_path: Optional[str] = None, overrides: Optional[List] = None) -> HumaniflowConfig:
    """Defaults → yaml merge → CLI dotted-path overrides."""
    cfg = get_humaniflow_cfg_defaults()
    if yaml_path is not None:
        import yaml

        with open(yaml_path) as f:
            _merge_dict(cfg, yaml.safe_load(f) or {})
    if overrides:
        apply_overrides(cfg, overrides)
    return cfg


def load_optimise_config(yaml_path: Optional[str] = None) -> OptimiseConfig:
    """Optimise defaults → yaml merge (reference scripts/run_optimise.py
    --optimise_cfg / configs/optimise_config.py)."""
    cfg = get_optimise_cfg_defaults()
    if yaml_path is not None:
        import yaml

        with open(yaml_path) as f:
            _merge_dict(cfg, yaml.safe_load(f) or {})
    return cfg


def save_config(cfg, yaml_path: str):
    """Freeze the config to the experiment dir for reproducible resume
    (reference: scripts/run_train.py:45-46)."""
    import yaml

    with open(yaml_path, "w") as f:
        yaml.safe_dump(dataclasses.asdict(cfg), f, sort_keys=False)
