from . import image_ops, label_conversions

__all__ = ["image_ops", "label_conversions"]
