"""Operations and bytes of ViTPose on B crops, counted from the
configuration's widths (never from the program's modules), two per
multiply-add.

Per image, T tokens of width D (T = the patch grid, 16×12 at 256×192 with
padding 2), hidden width 4D:

* the patch embedding, 2·(3·p²)·D a token;
* each block's four products, qkv 2·T·D·3D, proj 2·T·D², fc1 and fc2
  2·T·D·4D each: 24·T·D² a block;
* each block's two attention products, QKᵀ and PV, 2·T²·D each;
* the head: each deconvolution (k 4, s 2) 2·in·(k/s)²·out an output pixel,
  the 1×1 convolution 2·in·K an output pixel.

ViTPose-H at 256×192: 122.8 G multiply-adds an image without the attention
products (the paper's 122.9 GFLOPs, mmcv's count, leaves them out), 251.7
GFLOP with them.  Left out: LayerNorm, GELU, the softmax, the residual
additions, BatchNorm and ReLU, bound by memory, not by the arithmetic peak.

`block_products(cfg, rows)` gives, for one block at `rows` = B·T tokens,
(operations, bytes) of each of its four products as the bf16 GEMMs compute
them: the activations, the weight and the bias read once in bf16 and the
output written once in bf16.
"""

from .peaks import bound_s


def grid(cfg: dict):
    """(Hp, Wp) of the patch embedding's output."""
    p, pad = cfg["PATCH_SIZE"], cfg["PATCH_PADDING"]
    w, h = cfg["INPUT_WH"]
    return (h + 2 * pad - p) // p + 1, (w + 2 * pad - p) // p + 1


def tokens(cfg: dict) -> int:
    hp, wp = grid(cfg)
    return hp * wp


def block_products(cfg: dict, rows: int) -> list:
    """[(operations, bytes)] of qkv, proj, fc1 and fc2 at `rows` tokens."""
    d = cfg["EMBED_DIM"]
    hidden = int(d * cfg["MLP_RATIO"])
    out = []
    for k, n in ((d, 3 * d), (d, d), (d, hidden), (hidden, d)):
        out.append((2 * rows * k * n, 2 * (rows * k + k * n + n + rows * n)))
    return out


def attention_flops(cfg: dict) -> int:
    """QKᵀ and PV of every block, one image."""
    t = tokens(cfg)
    return cfg["DEPTH"] * 2 * (2 * t * t * cfg["EMBED_DIM"])


def head_flops(cfg: dict) -> int:
    hp, wp = grid(cfg)
    flops, in_ch = 0, cfg["EMBED_DIM"]
    for f in cfg["DECONV_FILTERS"]:
        hp, wp = 2 * hp, 2 * wp
        flops += 2 * in_ch * 4 * f * hp * wp
        in_ch = f
    return flops + 2 * in_ch * cfg["NUM_JOINTS"] * hp * wp


def flops_per_image(cfg: dict, attention: bool = True) -> int:
    t, d, p = tokens(cfg), cfg["EMBED_DIM"], cfg["PATCH_SIZE"]
    flops = 2 * 3 * p * p * d * t
    flops += cfg["DEPTH"] * sum(f for f, _ in block_products(cfg, t))
    flops += head_flops(cfg)
    return flops + (attention_flops(cfg) if attention else 0)


def blocks_bound_s(cfg: dict, b: int) -> float:
    """The least time of the blocks' 4·DEPTH products at B images, each at
    its own bound at the bf16 peak."""
    return cfg["DEPTH"] * sum(bound_s(f, n, "bf16") for f, n in block_products(cfg, b * tokens(cfg)))
