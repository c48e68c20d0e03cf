"""Batched PyTorch kernels of the forward step.

Each stage is a function on ``(B, ...)`` int32/uint8 tensors.  The stages
the JAX package also wrote as TPU kernels — cleanup+compress, the window
common run of table slots and the window runs of resident slots — launch
CUDA C++ kernels (``csrc/``) on CUDA tensors and run their plain PyTorch
versions on CPU tensors.
"""
