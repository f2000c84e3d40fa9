from .evaluate import evaluate_humaniflow
from .predict import (
    build_proxy_representation,
    make_predict_fn,
    predict_humaniflow,
    save_pred_output,
)
from .predict_hrnet import predict_hrnet_batch
from .protocols import EVAL_METRICS_3DPW, EVAL_METRICS_SSP3D

__all__ = [
    "EVAL_METRICS_3DPW",
    "EVAL_METRICS_SSP3D",
    "build_proxy_representation",
    "evaluate_humaniflow",
    "make_predict_fn",
    "predict_hrnet_batch",
    "predict_humaniflow",
    "save_pred_output",
]
