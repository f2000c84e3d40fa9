"""The benchmark's plain reference of HuManiFlow and HRNet-W48.

Plain PyTorch, written as functions over a flat dict of weights keyed as the
models' checkpoints are.  It imports nothing of the program under test
(`humaniflow_torch`) and nothing of JAX: each module here is a frozen copy of
the program's plain (CPU) arithmetic as it stood when the benchmark was
written, so a later change to the program cannot move the yardstick.  The
kernels' places are taken by their plain formulas (SMPL's skinning as
einsums).

`precision` selects the arithmetic: "float32" with TF32 off (what the
configurations state), or "tf32", the control one step below it.
"""
