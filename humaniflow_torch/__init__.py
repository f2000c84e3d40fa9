"""humaniflow_torch: the PyTorch + CUDA port of humaniflow_tpu.

Probabilistic 3D human pose and shape estimation (HuManiFlow) on an NVIDIA
Hopper GPU.  The JAX package `humaniflow_tpu` stays in the repository as the
reference; this package imports nothing of it (nor JAX) and keeps its own
copies of what it needs.  Its subpackages mirror the JAX package's, so each
module's counterpart is found by path.  The two SMPL kernels of the
distribution-inference path are written by hand in CUDA for sm_90a
(models/cuda_lbs.py, csrc/smpl_lbs.cu); everything else is plain PyTorch.

Devices: the entry points (predict_humaniflow, make_predict_fn,
HumaniflowModel, synthetic_smpl, SMPLModel.to) run on CUDA unless the caller
passes device="cpu", and raise when CUDA is absent instead of falling back.

Numerics: nothing that produces a rotation, a vertex or a variance runs in
TF32.  The encoder and Canny convolutions run under
`torch.backends.cudnn.flags(allow_tf32=False)` (models/resnet.py
fp32_convolutions), and the port leaves
`torch.backends.cuda.matmul.allow_tf32` at its default, False, so matmuls
and einsums are full float32.  The SMPL kernels use float32 FMAs only.
"""
