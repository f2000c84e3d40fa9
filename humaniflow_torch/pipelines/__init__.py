from .predict import (
    build_proxy_representation,
    make_predict_fn,
    predict_humaniflow,
    save_pred_output,
)

__all__ = [
    "build_proxy_representation",
    "make_predict_fn",
    "predict_humaniflow",
    "save_pred_output",
]
