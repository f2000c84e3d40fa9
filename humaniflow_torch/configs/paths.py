"""Path constants: the PyTorch package's own copy of
`humaniflow_tpu/configs/paths.py`.

All paths resolve relative to MODEL_FILES_DIR / DATA_DIR, overridable via
environment variables so the package works without editing source.
Large binaries (SMPL pkls, network weights) are external downloads.
"""

import os

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
MODEL_FILES_DIR = os.environ.get(
    "HUMANIFLOW_MODEL_FILES", os.path.join(REPO_ROOT, "model_files")
)
DATA_DIR = os.environ.get("HUMANIFLOW_DATA", os.path.join(REPO_ROOT, "datasets"))

# SMPL body model (converted .npz; see utils/convert_torch.py for the
# pkl→npz converter)
SMPL_DIR = os.path.join(MODEL_FILES_DIR, "smpl")
SMPL_NEUTRAL = os.path.join(SMPL_DIR, "SMPL_NEUTRAL.npz")
SMPL_MALE = os.path.join(SMPL_DIR, "SMPL_MALE.npz")
SMPL_FEMALE = os.path.join(SMPL_DIR, "SMPL_FEMALE.npz")

# Extra joint regressors (same npys the reference ships)
J_REGRESSOR_EXTRA = os.path.join(MODEL_FILES_DIR, "J_regressor_extra.npy")
COCOPLUS_REGRESSOR = os.path.join(MODEL_FILES_DIR, "cocoplus_regressor.npy")
H36M_REGRESSOR = os.path.join(MODEL_FILES_DIR, "J_regressor_h36m.npy")

# DensePose UV processing for the IUV renderer
DENSEPOSE_UV = os.path.join(MODEL_FILES_DIR, "UV_Processed.mat")

# Network weights (converted orbax checkpoints or source torch checkpoints)
HUMANIFLOW_WEIGHTS = os.path.join(MODEL_FILES_DIR, "humaniflow_weights.tar")
HRNET_WEIGHTS = os.path.join(MODEL_FILES_DIR, "pose_hrnet_w48_384x288.pth")

# Eval datasets
SSP3D_PATH = os.path.join(DATA_DIR, "ssp_3d")
PW3D_PATH = os.path.join(DATA_DIR, "3dpw", "test")

# Training assets
TRAIN_POSES_PATH = os.path.join(DATA_DIR, "training", "smpl_train_poses.npz")
TRAIN_TEXTURES_PATH = os.path.join(DATA_DIR, "training", "smpl_train_textures.npz")
TRAIN_BACKGROUNDS_PATH = os.path.join(DATA_DIR, "training", "lsun_backgrounds", "train")
VAL_POSES_PATH = os.path.join(DATA_DIR, "training", "smpl_val_poses.npz")
VAL_TEXTURES_PATH = os.path.join(DATA_DIR, "training", "smpl_val_textures.npz")
VAL_BACKGROUNDS_PATH = os.path.join(DATA_DIR, "training", "lsun_backgrounds", "val")
