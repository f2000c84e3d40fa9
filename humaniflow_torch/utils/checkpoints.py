"""Training checkpoints with torch.save.

The counterpart of `humaniflow_tpu/utils/checkpoints.py` (orbax there): the
same logical content, {epoch, best_epoch, best_epoch_val_metrics, params,
best_params, opt_state}, with params as model state_dicts and opt_state as
the optimizer's state_dict, saved as `<name>.pt`.
"""

import os
from typing import Any, Dict

import numpy as np
import torch


def save_checkpoint(save_dir: str, name: str, state: Dict[str, Any]) -> str:
    """Save a checkpoint dict to save_dir/name.pt; returns the path."""
    os.makedirs(save_dir, exist_ok=True)
    path = os.path.join(save_dir, f"{name}.pt")
    torch.save(state, path)
    return path


def load_checkpoint(path: str, map_location="cpu") -> Dict[str, Any]:
    """A checkpoint saved by save_checkpoint (".pt" may be left out)."""
    if not os.path.exists(path) and os.path.exists(path + ".pt"):
        path = path + ".pt"
    return torch.load(path, map_location=map_location, weights_only=False)


def load_training_info_from_checkpoint(state: Dict[str, Any], save_val_metrics):
    """Resume bookkeeping: (next epoch, best epoch, best val metrics), the
    metrics a checkpoint lacks filled with inf."""
    current_epoch = int(state["epoch"]) + 1
    best_epoch = int(state.get("best_epoch", state["epoch"]))
    stored = state.get("best_epoch_val_metrics", {})
    best_epoch_val_metrics = {m: float(stored.get(m, np.inf)) for m in save_val_metrics}
    return current_epoch, best_epoch, best_epoch_val_metrics
