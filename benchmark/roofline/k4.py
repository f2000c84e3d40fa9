"""Kernel K4 (the attribute rasterizer: `face_bands_kernel` then
`raster_kernel`) in the synthetic batch's render: bytes of one launch,
counted from its shapes as the program's `chip_smoke.py` counted them when
the benchmark was written (a frozen copy).

Bytes: the meshes' screen coordinates (B, 7829 DensePose vertices, 3), the
face table (13774, 3), the per-face constants (B, 13774, 4: the lit
texel's RGB and the part id), and written once the depth and the 4 planes
(B, H, W, 1 + 4) and the overflow (B,), float32 or int32.  Its operations
(13 per pixel test, 45 per kept face and per covered pixel) depend on where
the bodies fall; at the training shape they take about a tenth of the bytes'
time (`chip_smoke.py` phase 11), so the bound is the bytes'."""

from .peaks import HBM_BYTES_PER_S

DENSEPOSE_VERTS = 7829
DENSEPOSE_FACES = 13774
CONSTANTS = 4  # per face: lit RGB and the part id
KERNELS = ("face_bands_kernel", "raster_kernel")


def launch_bytes(meshes: int, image_size: int) -> int:
    return 4 * (meshes * DENSEPOSE_VERTS * 3 + DENSEPOSE_FACES * 3 + meshes * DENSEPOSE_FACES * CONSTANTS
                + meshes * image_size * image_size * (1 + CONSTANTS) + meshes)


def launch_bound_s(meshes: int, image_size: int) -> float:
    return launch_bytes(meshes, image_size) / HBM_BYTES_PER_S
