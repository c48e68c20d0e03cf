"""portello-tpu on PyTorch and CUDA: the liftover main path for one NVIDIA GPU.

A second package beside ``portello_tpu`` (the JAX reference, which it is held
against bit for bit by ``tests/test_torch_*.py``).  Module names mirror the
JAX package so each counterpart is easy to find:

- ``kernels``   batched ``(B, ...)`` int32 PyTorch ops for the liftover,
  cleanup+compress, cluster and simplify stages, and the resident genome.
  Three stages run as CUDA C++ kernels written for Hopper (``csrc/``), each
  with a plain PyTorch version beside it that runs for CPU tensors.
- ``models``    the bucket table and the forward steps ``fwd_batch_resident``
  (resident slots, the default) and ``fwd_batch`` (table slots).
- ``pipeline``  the native C++ feed (shared with ``portello_tpu``) driving
  the forward step.
- ``main``      the CLI: ``python -m portello_tpu_torch.main``.

Host code without a backend (I/O, phase 1, the numpy oracle, the C++ scanner)
is imported from ``portello_tpu``, never copied.  Nothing here imports jax.
"""
