"""Silhouette rendering: the exact coverage scan, kernel K3 and the
renderer's silhouette path."""

from .renderer import TexturedIUVRenderer, load_densepose_uv_host

__all__ = ["TexturedIUVRenderer", "load_densepose_uv_host"]
