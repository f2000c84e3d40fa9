"""DensePose UV tables, read on the host.

The port's own copy of `_densepose_uv_host` from
`humaniflow_tpu/render/renderer.py`; the renderer itself is not ported yet.
"""

from functools import lru_cache
from typing import Optional

import numpy as np

from ..configs import paths


def load_densepose_uv_host(mat_path: Optional[str] = None) -> dict:
    """DensePose UV data as numpy arrays, read once per process: faces
    (13774, 3) into 7829 DensePose vertices, vertex_map (7829,) into the
    6890 SMPL vertices, per-face part ids, u/v and SURREAL atlas u/v."""
    return dict(_densepose_uv_host(mat_path or paths.DENSEPOSE_UV))


@lru_cache(maxsize=4)
def _densepose_uv_host(mat_path: str):
    from scipy.io import loadmat

    m = loadmat(mat_path)
    faces = np.asarray(m["All_Faces"], np.int64) - 1
    vertex_map = np.asarray(m["All_vertices"], np.int64)[0] - 1
    face_part = np.asarray(m["All_FaceIndices"], np.int64)[:, 0]
    u = np.asarray(m["All_U_norm"], np.float64)[:, 0]
    v = np.asarray(m["All_V_norm"], np.float64)[:, 0]

    # Per-vertex part index from any face containing the vertex.
    vert_part = np.zeros(7829, np.int64)
    vert_part[faces.reshape(-1)] = np.repeat(face_part, 3)

    # SURREAL texture atlas: 4 columns × 6 rows of per-part tiles.
    col = (vert_part - 1) % 4
    row = (vert_part - 1) // 4
    atlas_u = (col + u) / 4.0
    atlas_v = (row + (1.0 - v)) / 6.0

    return {
        "faces": np.asarray(faces, np.int32),
        "vertex_map": np.asarray(vertex_map, np.int32),
        "face_part": np.asarray(face_part, np.int32),
        "u": np.asarray(u, np.float32),
        "v": np.asarray(v, np.float32),
        "atlas_u": np.asarray(atlas_u, np.float32),
        "atlas_v": np.asarray(atlas_v, np.float32),
        "face_atlas_u": np.asarray(atlas_u[faces].mean(1), np.float32),
        "face_atlas_v": np.asarray(atlas_v[faces].mean(1), np.float32),
    }
