"""The roofline and MFU counts against values worked out by hand for small
shapes."""

import copy
import json
import os

import pytest

from benchmark.harness.cell import BENCH_DIR
from benchmark.roofline import hrnet, humaniflow, k2_fwd, k4, peaks


def _config(name):
    with open(os.path.join(BENCH_DIR, "configs", f"{name}.json")) as f:
        return json.load(f)


def test_k2_forward_counts_951_fmas_and_each_byte_once():
    assert k2_fwd.fmas_per_row_vertex(10) == 951
    flops, nbytes = k2_fwd.work(rows=2, num_verts=5, num_betas=10)
    assert flops == 2 * 5 * 2 * 951
    inputs = 2 * (24 * 12 + 10 + 207) + 5 * (3 + 30 + 621 + 24)
    assert nbytes == 4 * (inputs + 2 * 3 * 5)
    assert k2_fwd.launch_bound_s(2, 5, 10) == pytest.approx(max(flops / 67e12, nbytes / 3.35e12))


def test_encoder_counts_resnet18_at_a_small_input():
    m = {"NUM_RESNET_LAYERS": 18, "NUM_IN_CHANNELS": 1, "NUM_SMPL_BETAS": 1}
    # 32²: conv1 → 16², pool → 8², stages at 8², 4², 2², 1²
    hand = 2 * 1 * 49 * 64 * 16 * 16
    hand += 4 * 2 * 64 * 9 * 64 * 8 * 8
    for f, s, fin in ((128, 4, 64), (256, 2, 128), (512, 1, 256)):
        hand += 2 * fin * 9 * f * s * s + 2 * fin * f * s * s + 3 * 2 * f * 9 * f * s * s
    hand += 2 * (512 * 512 + 512 * 2 + 512 * 6 + 512 * 3)
    assert humaniflow.encoder_flops(m, 32) == hand


def test_flow_row_counts_the_hypernets_splines_and_contexts():
    m = copy.deepcopy(_config("humaniflow_r18")["MODEL"])
    per_part = 2 * (256 + 63) * 64 + 12
    per_part += 2 * (2 * 65 * 64 + 2 * 64 + 2 * 64 * 32 + 2 * 32 + 2 * 32 * 32 + 2 * 32 + 2 * 32 * 62 + 2 * 62
                     + 2 * 190)
    assert humaniflow.flow_row_flops(m) == 2 * (512 + 10 + 9 + 3) * 256 + 23 * per_part


def test_predict_flops_adds_its_parts():
    c = _config("humaniflow_r18")
    b, n = 2, 3
    want = (b * humaniflow.encoder_flops(c["MODEL"], 256) + b * (n + 1) * humaniflow.flow_row_flops(c["MODEL"])
            + b * (n + 2) * 6890 * 2 * 951)
    assert humaniflow.predict_flops(c, b, n) == want


def test_k4_counts_its_inputs_and_outputs_once():
    # 2 meshes at 8²: screen coordinates, faces, per-face constants, depth and 4 planes, overflow
    hand = 4 * (2 * 7829 * 3 + 13774 * 3 + 2 * 13774 * 4 + 2 * 64 * 5 + 2)
    assert k4.launch_bytes(2, 8) == hand
    assert k4.launch_bound_s(2, 8) == hand / 3.35e12
    # 72 meshes at 256² as chip_smoke.py's bound: 0.0350 ms
    assert round(1e3 * k4.launch_bound_s(72, 256), 4) == 0.0350


def test_train_flops_add_the_synthetic_batch_and_three_forwards():
    c = _config("humaniflow_r18")
    b, n = 2, c["LOSS"]["NUM_J2D_SAMPLES"]
    m = c["MODEL"]
    density = 2 * (512 + 10 + 12) * 256 + 23 * (2 * (256 + 63) * 64 + 3 * humaniflow.flow_part_density_flops(m))
    forward = (b * humaniflow.encoder_flops(m, 256) + b * (n + 1) * humaniflow.flow_row_flops(m) + b * density
               + b * (n + 1) * 6890 * 2 * 951)
    assert humaniflow.train_step_flops(c, b) == b * 6890 * 2 * 951 + 3 * forward


def test_hrnet_counts_a_one_stage_net_by_hand():
    cfg = {"STAGE_CHANNELS": [2, 4, 8, 16], "STAGE_BLOCKS": 1, "STAGE_MODULES": [1, 0, 0], "NUM_JOINTS": 1,
           "INPUT_WH": [16, 16]}
    hand = 2 * 3 * 9 * 64 * 8 * 8 + 2 * 64 * 9 * 64 * 4 * 4
    hand += 2 * 64 * 64 * 16 + 2 * 64 * 9 * 64 * 16 + 2 * 64 * 256 * 16 + 2 * 64 * 256 * 16  # block 0 + downsample
    hand += 3 * (2 * 256 * 64 * 16 + 2 * 64 * 9 * 64 * 16 + 2 * 64 * 256 * 16)
    hand += 2 * 256 * 9 * 2 * 16 + 2 * 256 * 9 * 4 * 4  # transitions to 4² and 2²
    hand += 2 * 2 * 9 * 2 * 16 * 2 + 2 * 4 * 9 * 4 * 4 * 2  # one BASIC block a branch
    hand += 2 * 4 * 2 * 4 + 2 * 2 * 9 * 4 * 4  # fuse 0←1 (1×1 at 2²), 1←0 (3×3 stride 2 to 2²)
    hand += 2 * 4 * 9 * 8 + 2 * 8 * 9 * 16  # transitions to stages 3 and 4 (1² each), which have no modules
    hand += 2 * 2 * 1 * 16  # final layer
    assert hrnet.conv_flops(cfg) == hand


def test_peaks_are_the_published_h100_sxm_rates():
    assert (peaks.FP32_FLOPS, peaks.BF16_FLOPS, peaks.HBM_BYTES_PER_S) == (67e12, 989e12, 3.35e12)
    assert peaks.bound_s(67e12, 0) == 1.0 and peaks.bound_s(0, 3.35e12) == 1.0
