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
- ``pipeline``  phase 1 (the contig scan) and phase 2: the native C++ feed
  driving the device steps, and the Python feed (``read_scan``).
- ``main``      the CLI: ``python -m portello_tpu_torch.main``.

The package stands alone.  The host code without a backend (``io``, with
the C++ codec and scanner in ``io/native``; the numpy oracle ``ops``;
``utils``, ``tools``, phase 1 and the Python feed) is this package's own
copy of the JAX package's modules, at the same relative paths and equal to
them but for the import paths.  Nothing here imports ``portello_tpu`` or
jax.
"""
