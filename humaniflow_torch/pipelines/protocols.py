"""Shipped evaluation protocols: the per-dataset metric lists, the port's
copy of `humaniflow_tpu/pipelines/protocols.py`.

3DPW adds the min-over-samples variants of every point-estimate metric;
SSP-3D adds the silhouette metrics (point-estimate and per-sample IOU).
"""

_PW3D_POINT_METRICS = [
    "PVE", "PVE-SC", "PVE-PA", "PVE-T-SC", "MPJPE", "MPJPE-SC", "MPJPE-PA",
]

EVAL_METRICS_3DPW = (
    _PW3D_POINT_METRICS
    + [m + "_samples_min" for m in _PW3D_POINT_METRICS]
    + [
        "joints2D-L2E",
        "joints2Dsamples-L2E",
        "verts3D_sample_diversity",
        "joints3D_sample_diversity",
        "joints3D_invis_sample_diversity",
        "joints3D_vis_sample_diversity",
    ]
)

EVAL_METRICS_SSP3D = [
    "PVE-SC",
    "PVE-PA",
    "PVE-T-SC",
    "joints2D-L2E",
    "silhouette-IOU",
    "joints2Dsamples-L2E",
    "silhouettesamples-IOU",
    "verts3D_sample_diversity",
    "joints3D_sample_diversity",
    "joints3D_invis_sample_diversity",
    "joints3D_vis_sample_diversity",
]
