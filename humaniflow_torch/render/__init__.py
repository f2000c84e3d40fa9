"""Rendering: the exact scans, kernels K3 (coverage), K4 (attribute
rasterizer) and K6 (tile-culled rasterizer) and the textured IUV renderer."""

from .rasterizer import (
    Fragments,
    face_normals,
    interpolate_face_attributes,
    project_orthographic_screen,
    project_perspective_screen,
    rasterize,
)
from .renderer import DEFAULT_LIGHTS, TexturedIUVRenderer, load_densepose_uv, load_densepose_uv_host

__all__ = [
    "DEFAULT_LIGHTS",
    "Fragments",
    "TexturedIUVRenderer",
    "face_normals",
    "interpolate_face_attributes",
    "load_densepose_uv",
    "load_densepose_uv_host",
    "project_orthographic_screen",
    "project_perspective_screen",
    "rasterize",
]
