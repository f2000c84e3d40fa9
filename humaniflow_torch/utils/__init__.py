from .checkpoints import load_checkpoint, load_training_info_from_checkpoint, save_checkpoint
from .sampling import compute_vertex_variance_from_samples, joints2d_error_sorted_verts_sampling, so3_uniform_sampling

__all__ = [
    "compute_vertex_variance_from_samples",
    "joints2d_error_sorted_verts_sampling",
    "load_checkpoint",
    "load_training_info_from_checkpoint",
    "save_checkpoint",
    "so3_uniform_sampling",
]
