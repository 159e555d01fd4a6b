"""PyTorch/CUDA port of ``ocm_tpu`` for NVIDIA Hopper GPUs.

The JAX package ``ocm_tpu`` stays the reference; each module here mirrors
its namesake there (``ops/linalg.py``, ``ops/special.py``,
``ops/kernels.py``, ``stats/limits.py``, ``models/simca.py``) and is held
against it by ``tests/test_torch_port_*.py``.

This package imports ``torch``, ``numpy`` and the standard library only:
never ``jax`` and nothing of ``ocm_tpu``.  Entry points run on the CUDA
device unless the caller passes ``device="cpu"`` or CPU tensors; with no
GPU present they raise instead of falling back to the CPU.
"""
