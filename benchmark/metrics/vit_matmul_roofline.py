"""The blocks' bf16 products (qkv, proj, fc1, fc2 of each of the DEPTH
blocks: cuBLAS's GEMM kernels) against their roofline, in %: the sum of
each product's bound at the bf16 peak (benchmark/roofline/vitpose.py) over
the sum of the matched launches' device times.  A trace with another count
of matched launches than 4·DEPTH a call gives nothing."""

from benchmark.harness.cell import roofline


def is_block_gemm(name: str) -> bool:
    """cuBLAS's bf16 GEMM kernels (its nvjet family), the blocks' products
    on the H100 (torch 2.11, CUDA 12.8: `nvjet_tst_256x128_64x4_1x4_h_bz_coopA_bias_TNT`
    64 a call, `nvjet_tst_192x192_64x4_1x2_h_bz_coopB_bias_TNN` and
    `..._2x1_v_bz_coopB_bias_TNN` 32 each); nothing else of the call is an
    nvjet kernel (the head's and HuManiFlow's products run in cuDNN, CUTLASS
    and sm80 xmma kernels)."""
    return name.startswith("nvjet")


def read(run):
    t = run["trace"]
    cfg = run["cell"].config
    if t is None or "VITPOSE" not in cfg:
        return None
    vp = cfg["VITPOSE"]
    us = t.kernel_us(is_block_gemm)
    if not us or len(us) != 4 * vp["DEPTH"] * t.calls:
        return None
    bound = t.calls * roofline("vitpose").blocks_bound_s(vp, run["cell"].traffic["batch"])
    return 100.0 * bound / (sum(us) / 1e6)
