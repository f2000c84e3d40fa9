"""Kernel K2's forward (SMPL's vertices, `smpl_verts_kernel`): operations and
bytes of one launch, counted from its shapes as the program's `chip_smoke.py`
counted them when the benchmark was written (a frozen copy).

Per (row, vertex): 3·(NB + 207) blend-shape FMAs, 288 for the 24 joints'
weighted 12-entry transforms and 12 to apply it: 951 FMAs at NB = 10, two
operations each.  Bytes: each input read once (a12 (rows, 24, 12), betas,
the 207 pose features, the template, shape and pose bases, the skinning
weights) and the (rows, 3, V) vertices written once, float32."""

from .peaks import bound_s

POSE_FEATURES = 207
JOINTS = 24


def fmas_per_row_vertex(num_betas: int) -> int:
    return 3 * (num_betas + POSE_FEATURES) + JOINTS * 12 + 12


def work(rows: int, num_verts: int, num_betas: int):
    """(operations, bytes) of one launch at `rows` rows."""
    flops = rows * num_verts * 2 * fmas_per_row_vertex(num_betas)
    inputs = rows * (JOINTS * 12 + num_betas + POSE_FEATURES) + num_verts * (3 + 3 * num_betas + 3 * POSE_FEATURES + JOINTS)
    return flops, 4 * (inputs + rows * 3 * num_verts)


def launch_bound_s(rows: int, num_verts: int, num_betas: int) -> float:
    return bound_s(*work(rows, num_verts, num_betas), "float32")
