"""The plain reference against the program at small sizes on the CPU, on
the same inputs: the prediction at B = 2, N = 3, HRNet in float32 and bf16,
its keypoint decode, the crop, and the synthetic training batch."""

import json
import os

import torch

from benchmark.harness import inputs
from benchmark.harness.cell import BENCH_DIR, make_entry
from benchmark.harness.predict import decode, prediction_numbers
from benchmark.reference import crop as ref_crop
from benchmark.reference import hrnet as ref_hrnet
from benchmark.tests._tiny import SEED, tiny_cell


def _hrnet_cfg():
    with open(os.path.join(BENCH_DIR, "configs", "hrnet_w48_humaniflow_r18.json")) as f:
        return json.load(f)["HRNET"]


def test_prediction_matches_the_program():
    cell = tiny_cell("r18_predict_n100")
    entry = make_entry(cell, SEED, "cpu")
    got = entry.call(0)
    want = entry.reference((0, got), "float32")
    gaps = prediction_numbers(got, want)
    assert gaps["proxy"] <= 1e-6 and gaps["heads"] <= 1e-6
    assert gaps["rotations"] <= 1e-5 and gaps["vertices"] <= 1e-5 and gaps["uncertainty"] <= 1e-4, gaps
    assert got["verts_samples"].shape == (2, 3, 6890, 3)


def test_hrnet_matches_the_program_in_float32_and_bf16():
    from humaniflow_torch.models.hrnet import PoseHighResolutionNet, get_kp_locations_confs_from_heatmaps

    cfg = _hrnet_cfg()
    w = inputs.draw_weights(inputs.hrnet_spec(cfg), torch.Generator().manual_seed(3), "cpu")
    x = torch.rand((1, 384, 288, 3), generator=torch.Generator().manual_seed(4))
    for dtype, tol in (("float32", 1e-5), ("bf16", 2e-2)):
        net = PoseHighResolutionNet(dtype=torch.bfloat16 if dtype == "bf16" else None, device="cpu")
        net.load_state_dict(w)
        with torch.no_grad():
            want = net(x)
            got = ref_hrnet.heatmaps(w, cfg, x, dtype)
        assert float((got - want).abs().max()) <= tol * float(want.abs().max())
    kp, conf = get_kp_locations_confs_from_heatmaps(want)
    kp_ref, conf_ref = decode(want, cfg)
    assert torch.equal(kp * 4.0, kp_ref) and torch.equal(conf, conf_ref)


def test_the_fp8_control_moves_the_heatmaps():
    cfg = _hrnet_cfg()
    w = inputs.draw_weights(inputs.hrnet_spec(cfg), torch.Generator().manual_seed(3), "cpu")
    x = torch.rand((1, 384, 288, 3), generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        bf16, fp8 = (ref_hrnet.heatmaps(w, cfg, x, d) for d in ("bf16", "fp8"))
    assert float((bf16 - fp8).abs().max()) > 1e-2 * float(bf16.abs().max())


def test_crop_matches_the_program():
    from humaniflow_torch.data.image_ops import batch_crop_affine

    g = torch.Generator().manual_seed(5)
    rgb = torch.rand((2, 60, 80, 3), generator=g)
    j2d = 80 * torch.rand((2, 17, 2), generator=g)
    centres, h, w = torch.tensor([[30.0, 40.0], [20.0, 50.0]]), torch.tensor([50.0, 30.0]), torch.tensor([20.0, 45.0])
    want = batch_crop_affine((32, 48), rgb=rgb, joints2d=j2d, bbox_centres=centres, bbox_heights=h, bbox_widths=w,
                             orig_scale_factor=1.2)
    got, joints, scale, trans = ref_crop.crop_affine((32, 48), rgb, centres, h, w, 1.2, joints2d=j2d)
    assert torch.allclose(got, want["rgb"], atol=1e-6) and torch.allclose(joints, want["joints2d"])
    assert torch.equal(scale, want["crop_scale"]) and torch.equal(trans, want["crop_trans"])


def test_a_nan_anywhere_reads_as_infinite():
    cell = tiny_cell("r18_predict_n100")
    entry = make_entry(cell, SEED, "cpu")
    got = {k: v.clone() for k, v in entry.call(0).items()}
    want = entry.reference((0, got), "float32")
    got["verts_samples"][0, 1, 2, 0] = float("nan")
    got["cam_wp"][1, 0] = float("nan")
    gaps = prediction_numbers(got, want)
    assert gaps["vertices"] == float("inf") and gaps["heads"] == float("inf")


def test_synthetic_batch_matches_the_program():
    """The reference's synthetic batches from the program's random states
    equal the program's at 64² (the render through K4's plain twin), and
    another state reads apart."""
    from benchmark.harness.train import synth_numbers

    entry = make_entry(tiny_cell("r18_train_b72"), SEED, "cpu")
    for p, state, batch in entry.first["batches"]:
        n = synth_numbers(batch, entry._reference_batch((p, state, batch)))
        assert n == {"synth_targets": 0.0, "synth_images": 0.0}, n
    p, state, batch = entry.first["batches"][0]
    other = torch.Generator().manual_seed(1).get_state()
    assert synth_numbers(batch, entry._reference_batch((p, other, batch)))["synth_images"] == 1.0
