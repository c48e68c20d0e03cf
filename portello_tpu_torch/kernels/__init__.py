"""Batched PyTorch kernels of the forward step.

Each stage is a function on ``(B, ...)`` int32/uint8 tensors.  The two stages
the JAX package also wrote as TPU kernels — cleanup+compress and the window
common run — launch CUDA C++ kernels (``csrc/``) on CUDA tensors and run
their plain PyTorch versions on CPU tensors.
"""
