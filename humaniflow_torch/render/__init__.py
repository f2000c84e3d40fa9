"""Rendering: the exact scans, kernels K3 (coverage), K4 (attribute
rasterizer) and K6 (tile-culled rasterizer) and the textured IUV renderer."""

from .renderer import TexturedIUVRenderer, load_densepose_uv_host

__all__ = ["TexturedIUVRenderer", "load_densepose_uv_host"]
