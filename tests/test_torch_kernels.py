"""Kernels K1 (smpl_moments) and K2 (smpl_verts) of csrc/smpl_lbs.cu against
their plain PyTorch twins, on an NVIDIA GPU.

Every test here is marked `cuda` and skips without a card.  The file imports
nothing of JAX, so that it also runs where JAX is not installed:

    python -m pytest tests/test_torch_kernels.py -q --noconftest
"""

import pytest
import torch

from humaniflow_torch.models import cuda_lbs

# Kernel against plain twin: 2e-5 m for vertices (float32 sums in another
# order); moments 1e-5 relative to each moment plane's largest value.
VERT_ATOL = 2e-5
MOM_RTOL = 1e-5


def _require_cuda():
    """Skip unless a CUDA device is present; decided at run time so that
    every test worker collects the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")


def _kernel_inputs_cuda(rows, v, nb=10, seed=0):
    g = torch.Generator("cuda").manual_seed(seed)
    r = lambda *s, sc=1.0: torch.randn(*s, generator=g, device="cuda") * sc  # noqa: E731
    return (
        r(*rows, 24, 12, sc=0.5), r(*rows, nb), r(*rows, 207, sc=0.5),
        r(3, v, sc=0.3), r(nb, 3, v, sc=0.01), r(207, 3, v, sc=0.001),
        torch.softmax(r(v, 24, sc=3.0), -1),
    )


@pytest.mark.cuda
@pytest.mark.parametrize("rows,v", [((37,), 1000), ((3200,), 6890)])
def test_smpl_verts_kernel_matches_plain(rows, v):
    _require_cuda()
    args = _kernel_inputs_cuda(rows, v)
    before = cuda_lbs.LAUNCHES["smpl_verts"]
    got = cuda_lbs.smpl_verts(*args)
    torch.cuda.synchronize()
    assert cuda_lbs.LAUNCHES["smpl_verts"] == before + 1
    torch.testing.assert_close(got, cuda_lbs.smpl_verts_plain(*args), rtol=0, atol=VERT_ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,v", [((3, 7), 1000), ((32, 100), 6890)])
def test_smpl_moments_kernel_matches_plain(rows, v):
    _require_cuda()
    args = _kernel_inputs_cuda(rows, v)
    before = cuda_lbs.LAUNCHES["smpl_moments"]
    got = cuda_lbs.smpl_moments(*args)
    torch.cuda.synchronize()
    assert cuda_lbs.LAUNCHES["smpl_moments"] == before + 1
    want = cuda_lbs.smpl_verts_moments_plain(*args)
    scale = want.abs().amax(dim=(0, 2, 3), keepdim=True)
    assert float(((got - want).abs() / scale).max()) <= MOM_RTOL


@pytest.mark.cuda
def test_kernel_wrappers_reject_bad_inputs():
    _require_cuda()
    args = list(_kernel_inputs_cuda((4,), 256))
    bad = {
        "dtype": lambda a: a.double(),
        "layout": lambda a: a.transpose(0, 1).contiguous().transpose(0, 1),
        "device": lambda a: a.cpu(),
    }
    for name, f in bad.items():
        broken = list(args)
        broken[3] = f(args[3])  # v_template_cm
        with pytest.raises((TypeError, ValueError)):
            cuda_lbs.smpl_verts(*broken)
    with pytest.raises(ValueError):
        cuda_lbs.smpl_verts(args[0][:, :23], *args[1:])
