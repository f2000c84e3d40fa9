"""humaniflow_torch: the PyTorch + CUDA port of humaniflow_tpu.

Probabilistic 3D human pose and shape estimation (HuManiFlow) on an NVIDIA
Hopper GPU.  The JAX package `humaniflow_tpu` stays in the repository as the
reference; this package imports nothing of it (nor JAX) and keeps its own
copies of what it needs.  Its subpackages mirror the JAX package's, so each
module's counterpart is found by path.  The kernels of the ported paths
are written by hand in CUDA for sm_90a: the SMPL kernels of distribution
inference and evaluation (models/cuda_lbs.py, csrc/smpl_lbs.cu), the
silhouette coverage kernel of SSP-3D evaluation (render/cuda_coverage.py,
csrc/coverage.cu) and the fused flow level that every autoregressive pass
with grad mode off takes, for a flow it supports (flows/cuda_level.py,
csrc/flow_level.cu);
everything else is plain PyTorch.

Devices: the entry points (predict_humaniflow, make_predict_fn,
predict_hrnet_batch, evaluate_humaniflow, HumaniflowModel,
PoseHighResolutionNet, ViTPose, TexturedIUVRenderer, synthetic_smpl, SMPLModel.to,
the predict CLI) run on CUDA unless the caller passes device="cpu", and
raise when CUDA is absent instead of falling back.

Numerics: nothing that produces a rotation, a vertex or a variance runs in
TF32.  The encoder and Canny convolutions run under
`torch.backends.cudnn.flags(allow_tf32=False)` (models/resnet.py
fp32_convolutions), and the port leaves
`torch.backends.cuda.matmul.allow_tf32` at its default, False, so matmuls
and einsums are full float32.  The kernels use float32 FMAs only.  HRNet
and ViTPose, the keypoint nets, run their convolutions and matrix products
in bf16 only when asked (dtype=torch.bfloat16).
"""
