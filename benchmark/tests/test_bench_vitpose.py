"""The ViTPose cell's pieces on the CPU: the roofline's count at the
published widths (122.8 G multiply-adds an image without the attention
products, the paper's 122.9 G); the plain reference against the program at
a tiny size, in float32 and bf16, and the fp8 control apart from both; the
matmul reader's kernel count; and the faults that must make the cell's run
not correct, each planted in the program at the cell's own widths (B = 2):
a block skipped, the qkv bias dropped, the position embedding's row-0 term
left out, the head's BatchNorm skipped."""

import copy
import json
import os

import pytest
import torch

from benchmark.harness.cell import BENCH_DIR, metric_reader
from benchmark.harness.predict_vitpose import vitpose_net, vitpose_spec
from benchmark.harness import inputs
from benchmark.reference import vitpose as ref_vitpose
from benchmark.roofline import vitpose as roof
from benchmark.run import run_cell
from benchmark.tests._tiny import SEED, tiny_cell

CELL = "vith_predict_uncropped_n50"


def _cfg():
    with open(os.path.join(BENCH_DIR, "configs", "vitpose_h_humaniflow_r18.json")) as f:
        return json.load(f)["VITPOSE"]


def _tiny_cfg():
    """The published crop, patch and head at a tiny width and depth."""
    cfg = copy.deepcopy(_cfg())
    cfg.update(EMBED_DIM=32, DEPTH=2, NUM_HEADS=4, DECONV_FILTERS=[16, 16])
    return cfg


def test_the_roofline_counts_the_papers_multiply_adds():
    cfg = _cfg()
    assert roof.grid(cfg) == (16, 12) and roof.tokens(cfg) == 192
    macs = roof.flops_per_image(cfg, attention=False) / 2
    assert abs(macs - 122.9e9) <= 0.005 * 122.9e9
    assert macs == pytest.approx(122.81e9, rel=1e-4)
    t, d = 192, 1280
    assert roof.attention_flops(cfg) == 32 * 4 * t * t * d
    assert roof.flops_per_image(cfg) == pytest.approx(251.66e9, rel=1e-4)
    qkv, proj, fc1, fc2 = roof.block_products(cfg, 32 * t)
    assert qkv == (2 * 6144 * d * 3 * d, 2 * (6144 * d + d * 3 * d + 3 * d + 6144 * 3 * d))
    assert fc1[0] == fc2[0] == 4 * proj[0]
    assert roof.blocks_bound_s(cfg, 32) == pytest.approx(32 * 24 * 6144 * d * d / 989e12, rel=1e-9)  # all compute-bound


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bf16", 3e-2)])
def test_the_reference_matches_the_program(dtype, tol):
    """bf16: each side rounds its products in its own order; the heatmaps'
    last rounding alone is an ulp, 2^-7 of a value in [1, 2)."""
    cfg = dict(_tiny_cfg(), DTYPE=dtype)
    w = inputs.draw_weights(vitpose_spec(cfg), torch.Generator().manual_seed(3), "cpu")
    net = vitpose_net(cfg, "cpu")
    net.load_state_dict(w, assign=True)
    x = torch.randn((2, 256, 192, 3), generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        got = net(x)
        want = ref_vitpose.heatmaps(w, cfg, x, dtype)
    assert got.shape == want.shape == (2, 64, 48, 17)
    assert float((got - want).abs().max()) <= tol * float(want.abs().max())


def test_the_fp8_control_moves_the_heatmaps():
    cfg = _tiny_cfg()
    w = inputs.draw_weights(vitpose_spec(cfg), torch.Generator().manual_seed(3), "cpu")
    x = torch.randn((1, 256, 192, 3), generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        bf16, fp8 = (ref_vitpose.heatmaps(w, cfg, x, d) for d in ("bf16", "fp8"))
    assert float((bf16 - fp8).abs().max()) > 5e-2 * float(bf16.abs().max())


class _Trace:
    def __init__(self, names, calls):
        self.kernels = [(n, 10.0 * i, 10.0 * i + 5.0) for i, n in enumerate(names)]
        self.calls = calls

    def kernel_us(self, match):
        return [e - s for n, s, e in self.kernels if match(n)]


def test_the_matmul_reader_wants_four_nvjet_gemms_a_block_a_call():
    read = metric_reader("vit_matmul_roofline")
    cell = tiny_cell(CELL)
    gemms = ["nvjet_tst_256x128_64x4_1x4_h_bz_coopA_bias_TNT"] * 64 + ["nvjet_tst_192x192_x"] * 64
    others = ["cutlass_75_tensorop_bf16_s1688gemm_bf16_64x64_tn_align1", "sm80_xmma_gemm_f32f32_f32f32_f32"]
    run = {"cell": cell, "trace": _Trace((gemms + others) * 2, 2)}
    bound = roof.blocks_bound_s(cell.config["VITPOSE"], cell.traffic["batch"])
    assert read(run) == pytest.approx(100.0 * bound / (128 * 5e-6))
    assert read({"cell": cell, "trace": _Trace((gemms + others) * 2 + gemms[:1], 2)}) is None
    assert read({"cell": cell, "trace": None}) is None


def _block_skipped(monkeypatch):
    """The middle block of the program's ViT returns its input."""
    from humaniflow_torch.models import vitpose

    real = vitpose.ViT.__init__

    def init(self, *args, **kwargs):
        real(self, *args, **kwargs)
        self.blocks[len(self.blocks) // 2].forward = lambda x: x

    monkeypatch.setattr(vitpose.ViT, "__init__", init)


def _qkv_bias_dropped(monkeypatch):
    """Every block's qkv product without its bias."""
    from humaniflow_torch.models import vitpose

    real = vitpose.Attention.forward

    def forward(self, x):
        bias, self.qkv.bias = self.qkv.bias, None
        try:
            return real(self, x)
        finally:
            self.qkv.bias = bias

    monkeypatch.setattr(vitpose.Attention, "forward", forward)


def _row_0_left_out(monkeypatch):
    """The tokens get their own position rows only, not row 0 as well."""
    from humaniflow_torch.models import vitpose

    def embed(self, x):
        tokens, hp, wp = self.patch_embed(x)
        return tokens + self.pos_embed[:, 1:], hp, wp

    monkeypatch.setattr(vitpose.ViT, "embed", embed)


def _head_bn_skipped(monkeypatch):
    """The head's deconvolutions go straight to ReLU."""
    from humaniflow_torch.models import vitpose

    def forward(self, x):
        for m in self.deconv_layers:
            if not isinstance(m, torch.nn.BatchNorm2d):
                x = m(x)
        return self.final_layer(x)

    monkeypatch.setattr(vitpose.TopdownHeatmapSimpleHead, "forward", forward)


FAULTS = {"block_skipped": _block_skipped, "qkv_bias_dropped": _qkv_bias_dropped,
          "row_0_left_out": _row_0_left_out, "head_bn_skipped": _head_bn_skipped}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_vitpose_is_not_correct(fault, monkeypatch):
    cell = tiny_cell(CELL)
    FAULTS[fault](monkeypatch)
    r = run_cell(cell, SEED, 0.3, False, device="cpu")
    assert not r["correct"]
    assert r["checked"]["vitpose"]["value"] > r["checked"]["vitpose"]["limit"], r["checked"]
