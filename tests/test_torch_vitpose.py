"""ViTPose (models/vitpose.py) and the keypoint stage that runs it, on the
CPU: the port against the plain reference (`_torch_vitpose_reference.py`)
at tiny widths in float32 and in bf16; the 16×12 grid that padding 2 gives
at 256×192 and the position embedding's row-0 rule; mmpose's state dict
through the loader, an unused or a missing tensor refused; the shared stage
at ViTPose's sizes (192×256 crops, keypoints ×4 to crop pixels) and at
HRNet's, bit for bit the explicit crop → HRNet → argmax; the `vitpose.*`
spans and the `vit_tokens` counter; the predict CLI with
`--keypoint_model vitpose_h`."""

import importlib
import math
import os

import _torch_parity  # noqa: F401  (its import caps the worker's OpenMP pool)
import _torch_vitpose_reference as ref
import numpy as np
import pytest
import torch

from humaniflow_torch.data.image_ops import batch_crop_affine
from humaniflow_torch.models import PoseHighResolutionNet, ViTPose, get_kp_locations_confs_from_heatmaps
from humaniflow_torch.models import vitpose as tvit
from humaniflow_torch.utils import tracing
from humaniflow_torch.utils.load_reference import load_vitpose_checkpoint

tph = importlib.import_module("humaniflow_torch.pipelines.predict_hrnet")

# tiny widths at the published crop: 16×12 tokens of width 32, 4 heads of 8
TINY = dict(embed_dim=32, depth=2, num_heads=4, mlp_ratio=4, qkv_bias=True, img_size=(256, 192), patch_size=16,
            patch_padding=2, deconv_filters=(16, 16), num_joints=17)


def random_state(net: ViTPose, seed: int) -> dict:
    """Every tensor of `net` drawn from `seed`, none zero or the identity:
    linear weights and the position embedding N(0, 0.02²)·√(1280/D) (the
    published scale's effect at width D), biases N(0, 0.02²), LayerNorm
    scales U(0.8, 1.2) and shifts N(0, 0.02²), the head LeCun-normal with
    randomised BatchNorm."""
    g = torch.Generator().manual_seed(seed)
    d = net.backbone.pos_embed.shape[-1]
    out = {}
    for k, v in net.state_dict().items():
        if k.endswith("num_batches_tracked"):
            out[k] = v.clone()
        elif k.endswith("running_var") or (k.endswith(".weight") and v.dim() == 1):
            out[k] = 0.8 + 0.4 * torch.rand(v.shape, generator=g)
        elif k.endswith("running_mean") or v.dim() == 1:
            out[k] = (0.1 if "keypoint_head" in k else 0.02) * torch.randn(v.shape, generator=g)
        elif "keypoint_head" in k or "patch_embed" in k:
            fan_in = v.shape[0] * 4 if "deconv" in k else v[0].numel()  # a k=4, s=2 deconvolution: 4 taps an input
            out[k] = torch.randn(v.shape, generator=g) / math.sqrt(fan_in)
        else:
            out[k] = 0.02 * math.sqrt(1280 / d) * torch.randn(v.shape, generator=g)
    return out


def tiny_net(dtype=None, seed=1, **kw):
    net = ViTPose(**{**TINY, **kw}, dtype=dtype, device="cpu")
    state = random_state(net, seed)
    net.load_state_dict(state)
    return net, state


def _crops(b=2, seed=3, hw=(256, 192)):
    return torch.randn((b, *hw, 3), generator=torch.Generator().manual_seed(seed))


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def test_port_matches_the_plain_reference_in_float32():
    net, w = tiny_net()
    x = _crops()
    with torch.no_grad():
        got = net(x)
    want = ref.heatmaps(w, x, TINY["depth"], TINY["num_heads"])
    assert got.shape == want.shape == (2, 64, 48, 17) and got.dtype == torch.float32
    assert _rel(got, want) <= 1e-5


def test_port_matches_the_plain_reference_in_bf16():
    """Both sides round every product to bf16 (8 significant bits), each in
    its own order (SDPA's blocked softmax, oneDNN's GEMM tiling), so a value
    can land an ulp apart at every product; the heatmaps' own last rounding
    alone is 2^-7 of a value in [1, 2), ~0.8% of the largest (here the port
    reads 0.73% off).  3e-2 leaves room for a few such ulps.  The float32 port
    reads 4e-7 off the float32 reference and the bf16 port 0.77%: the
    products did run in bf16."""
    net, w = tiny_net(torch.bfloat16)
    x = _crops()
    with torch.no_grad():
        got = net(x)
    want = ref.heatmaps(w, x, TINY["depth"], TINY["num_heads"], dtype="bf16")
    want32 = ref.heatmaps(w, x, TINY["depth"], TINY["num_heads"])
    assert got.dtype == torch.float32
    assert _rel(got, want) <= 3e-2
    assert _rel(got, want32) > 1e-3  # the products did run in bf16


def test_vitpose_h_is_the_published_model():
    """ViTPose-H's widths, built on the meta device (no memory): 637.2 M
    parameters, 630.9 M of them in the backbone, 16 heads of 80, an MLP of
    5,120, the 256×192 crop and 64×48 heatmaps."""
    net = ViTPose(**tvit.VITPOSE_H, device="meta", generator=torch.Generator())
    count = lambda m: sum(p.numel() for p in m.parameters())  # noqa: E731
    assert count(net) == 637_208_849 and count(net.backbone) == 630_912_000
    blk = net.backbone.blocks[0]
    assert len(net.backbone.blocks) == 32 and blk.attn.num_heads == 16 and blk.attn.qkv.weight.shape == (3840, 1280)
    assert blk.mlp.fc1.weight.shape == (5120, 1280) and blk.norm1.eps == 1e-6
    assert net.backbone.patch_embed.proj.padding == (2, 2) and net.backbone.pos_embed.shape == (1, 193, 1280)
    assert net.input_wh == (192, 256) and net.heatmap_wh == (48, 64)


def test_the_published_crop_gives_a_16x12_grid_and_row_0_goes_to_every_token():
    net, w = tiny_net(depth=0)
    assert net.input_wh == (192, 256) and net.heatmap_wh == (48, 64)
    assert w["backbone.pos_embed"].shape == (1, 193, 32)
    x = _crops(1)
    with torch.no_grad():
        tokens, hp, wp = net.backbone.embed(x.permute(0, 3, 1, 2))
        conv = net.backbone.patch_embed.proj(x.permute(0, 3, 1, 2))
    assert (hp, wp) == (16, 12) and conv.shape == (1, 32, 16, 12) and tokens.shape == (1, 192, 32)
    pos = w["backbone.pos_embed"][0]
    # token h·12 + w is the grid cell (h, w), plus position row 1 + h·12 + w, plus row 0
    for h, wc in ((0, 0), (3, 7), (15, 11)):
        want = conv[0, :, h, wc] + pos[1 + 12 * h + wc] + pos[0]
        torch.testing.assert_close(tokens[0, 12 * h + wc], want, rtol=0, atol=1e-6)
    # padding 2: the first patch reads rows and columns -2..13, the padding zeros
    manual = (net.backbone.patch_embed.proj.weight[:, :, 2:, 2:] * x[0, :14, :14].permute(2, 0, 1)).sum((1, 2, 3))
    torch.testing.assert_close(conv[0, :, 0, 0], manual + net.backbone.patch_embed.proj.bias, rtol=0, atol=1e-5)


def test_the_mmpose_checkpoint_loads_and_strays_are_refused(tmp_path):
    src, state = tiny_net(seed=7)
    names = set(state)
    for i in range(TINY["depth"]):
        for part in ("norm1", "attn.qkv", "attn.proj", "norm2", "mlp.fc1", "mlp.fc2"):
            assert f"backbone.blocks.{i}.{part}.weight" in names and f"backbone.blocks.{i}.{part}.bias" in names
    assert {"backbone.patch_embed.proj.weight", "backbone.pos_embed", "backbone.last_norm.weight",
            "keypoint_head.deconv_layers.0.weight", "keypoint_head.deconv_layers.1.running_var",
            "keypoint_head.deconv_layers.3.weight", "keypoint_head.deconv_layers.4.weight",
            "keypoint_head.final_layer.bias"} <= names
    path = str(tmp_path / "vitpose.pth")
    torch.save({"meta": {"epoch": 210}, "state_dict": state}, path)
    net = load_vitpose_checkpoint(path, ViTPose(**TINY, device="cpu"))
    for k, v in net.state_dict().items():
        torch.testing.assert_close(v, state[k], rtol=0, atol=0, msg=k)
    torch.save({"state_dict": {**state, "backbone.cls_token": torch.zeros(1, 1, 32)}}, path)
    with pytest.raises(KeyError, match="backbone.cls_token"):
        load_vitpose_checkpoint(path, ViTPose(**TINY, device="cpu"))
    torch.save({k: v for k, v in state.items() if k != "backbone.blocks.1.attn.qkv.bias"}, path)
    with pytest.raises(KeyError, match="backbone.blocks.1.attn.qkv.bias"):
        load_vitpose_checkpoint(path, ViTPose(**TINY, device="cpu"))


def _photos():
    rng = np.random.default_rng(5)
    photos = [rng.uniform(size=(120, 90, 3)).astype(np.float32), rng.uniform(size=(80, 140, 3)).astype(np.float32)]
    boxes = [((60.0, 45.0), 100.0, 50.0), ((40.0, 70.0), 70.0, 60.0)]
    return photos, boxes


def _explicit_stage(net, photos, boxes, input_wh, heatmap_wh):
    """The stage written out: each photo's crop, normalise, the net, argmax ×
    crop/heatmap."""
    crops = torch.cat([batch_crop_affine(
        input_wh, rgb=torch.as_tensor(p)[None], bbox_centres=torch.tensor([c]), bbox_heights=torch.tensor([h]),
        bbox_widths=torch.tensor([w]), orig_scale_factor=1.2)["rgb"] for p, (c, h, w) in zip(photos, boxes)])
    mean, std = torch.tensor(tph.IMAGENET_MEAN), torch.tensor(tph.IMAGENET_STD)
    with torch.no_grad():
        heat = net((crops - mean) / std)
    kp, conf = get_kp_locations_confs_from_heatmaps(heat)
    return crops, kp * (input_wh[0] / heatmap_wh[0]), conf


def test_the_stage_runs_vitpose_at_its_own_sizes():
    net, _ = tiny_net(torch.bfloat16)
    photos, boxes = _photos()
    got = tph.predict_hrnet_batch(net, photos, bboxes=boxes, device="cpu")
    assert tph.keypoint_sizes(net) == ((192, 256), (48, 64))
    assert got["cropped_images"].shape == (2, 256, 192, 3) and got["joints2D"].shape == (2, 17, 2)
    crops, kp, conf = _explicit_stage(net, photos, boxes, (192, 256), (48, 64))
    assert torch.equal(got["cropped_images"], crops)
    assert torch.equal(got["joints2D"], kp) and torch.equal(got["joints2Dconfs"], conf)
    assert float((kp % 4).abs().max()) == 0.0 and float(kp[..., 0].max()) <= 188 and float(kp[..., 1].max()) <= 252


def test_the_stage_runs_hrnet_as_before(monkeypatch):
    """HRNet at the stage's constants (patched small, as the other tests do):
    the stage's crops, keypoints and confidences are, bit for bit, the
    explicit crop → normalise → HRNet → argmax × 4."""
    monkeypatch.setattr(tph, "HRNET_INPUT_WH", (64, 96))
    monkeypatch.setattr(tph, "HRNET_HEATMAP_WH", (16, 24))
    hrnet = PoseHighResolutionNet(device="cpu", generator=torch.Generator().manual_seed(2))
    photos, boxes = _photos()
    assert tph.keypoint_sizes(hrnet) == ((64, 96), (16, 24))
    got = tph.predict_hrnet_batch(hrnet, photos, bboxes=boxes, device="cpu")
    crops, kp, conf = _explicit_stage(hrnet, photos, boxes, (64, 96), (16, 24))
    assert got["cropped_images"].shape == (2, 96, 64, 3)
    assert torch.equal(got["cropped_images"], crops)
    assert torch.equal(got["joints2D"], kp) and torch.equal(got["joints2Dconfs"], conf)


def test_the_vitpose_spans_and_its_token_count():
    net, _ = tiny_net()
    photos, _ = _photos()
    tracing.reset()
    with tracing.tracing():
        tph.predict_hrnet_batch(net, photos, device="cpu")  # no boxes: the keypoint-box fallback runs
    recs = tracing.records()
    tracing.reset()
    by_id = {r.id: r for r in recs}
    parents = {(r.name, by_id[r.parent].name if r.parent is not None else None) for r in recs}
    want = {("vitpose", None), ("vitpose.upload", "vitpose"), ("vitpose.crop", "vitpose"), ("crop", "vitpose.crop"),
            ("vitpose.net", "vitpose"), ("vitpose.embed", "vitpose.net"), ("vitpose.blocks", "vitpose.net"),
            ("vitpose.head", "vitpose.net"), ("vitpose.decode", "vitpose"), ("vitpose.fallback", "vitpose"),
            ("vitpose.crop", "vitpose.fallback"), ("vitpose.net", "vitpose.fallback"),
            ("vitpose.decode", "vitpose.fallback")}
    assert parents == want, parents ^ want
    assert not any(r.name.startswith("hrnet") for r in recs)
    blocks = [r for r in recs if r.name == "vitpose.blocks"]
    assert len(blocks) == 2 and all(r.counters == {"vit_tokens": 2 * 192} for r in blocks)


def test_the_predict_cli_runs_vitpose(tmp_path, monkeypatch):
    """`run_predict --keypoint_model vitpose_h --vitpose_checkpoint ...` on
    two PNGs on the CPU, ViTPose-H's widths shrunk, synthetic SMPL: the
    predictions, with the keypoints of the checkpoint's net."""
    cv2 = pytest.importorskip("cv2")
    import humaniflow_torch.models as TM
    from humaniflow_torch.cli import run_predict
    from humaniflow_torch.models import smpl as tsmpl

    monkeypatch.setattr(tvit, "VITPOSE_H", dict(TINY, depth=1))
    monkeypatch.setattr(TM, "load_smpl_npz", lambda *a, **k: tsmpl.synthetic_smpl(num_verts=6890, device=k["device"]))
    net, state = tiny_net(depth=1, seed=9)
    ckpt = str(tmp_path / "vitpose.pth")
    torch.save({"state_dict": state}, ckpt)
    img_dir, out_dir = tmp_path / "images", tmp_path / "out"
    img_dir.mkdir()
    rng = np.random.default_rng(7)
    for name, (h, w) in (("a.png", (48, 40)), ("b.png", (36, 52))):
        cv2.imwrite(str(img_dir / name), rng.integers(0, 255, size=(h, w, 3)).astype(np.uint8))
    cfg = tmp_path / "small.yaml"
    cfg.write_text("DATA:\n  PROXY_REP_SIZE: 32\n")
    run_predict.main(["-I", str(img_dir), "-S", str(out_dir), "--keypoint_model", "vitpose_h", "--vitpose_checkpoint",
                      ckpt, "--hrnet_dtype", "f32", "-N", "3", "--cfg", str(cfg), "--device", "cpu"])
    assert sorted(os.listdir(out_dir)) == ["a_pred.npz", "b_pred.npz"]
    photos = [cv2.cvtColor(cv2.imread(str(img_dir / f)), cv2.COLOR_BGR2RGB).astype(np.float32) / 255.0
              for f in ("a.png", "b.png")]
    want = tph.predict_hrnet_batch(net, photos, device="cpu")  # one batch, as the CLI runs them
    for i, stem in enumerate("ab"):
        pred = np.load(out_dir / f"{stem}_pred.npz")
        np.testing.assert_array_equal(pred["hrnet_joints2D"], want["joints2D"][i].numpy())
        np.testing.assert_array_equal(pred["hrnet_joints2D_conf"], want["joints2Dconfs"][i].numpy())
