from .evaluate import evaluate_humaniflow, make_eval_step
from .optimise import make_optimise_fn, optimise_batch_with_humaniflow_prior
from .predict import (
    build_proxy_representation,
    make_predict_fn,
    predict_humaniflow,
    save_pred_output,
)
from .predict_hrnet import bbox_from_keypoints, detect_person_bbox_torchvision, predict_hrnet, predict_hrnet_batch
from .protocols import EVAL_METRICS_3DPW, EVAL_METRICS_SSP3D
from .train import make_optimizer, make_synth_data_fn, make_training_renderer, train_humaniflow
from .train_step import make_train_step, predict_joints2d

__all__ = [
    "EVAL_METRICS_3DPW",
    "EVAL_METRICS_SSP3D",
    "bbox_from_keypoints",
    "build_proxy_representation",
    "detect_person_bbox_torchvision",
    "evaluate_humaniflow",
    "make_eval_step",
    "make_optimise_fn",
    "make_optimizer",
    "make_predict_fn",
    "make_synth_data_fn",
    "make_training_renderer",
    "make_train_step",
    "optimise_batch_with_humaniflow_prior",
    "predict_joints2d",
    "predict_hrnet",
    "predict_hrnet_batch",
    "predict_humaniflow",
    "save_pred_output",
    "train_humaniflow",
]
