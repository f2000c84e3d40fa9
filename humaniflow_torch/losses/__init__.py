from .humaniflow_loss import humaniflow_loss

__all__ = ["humaniflow_loss"]
