"""The benchmark of ``ocm_tpu_torch``, the PyTorch and CUDA port, on one
NVIDIA H100: cells of ``BENCHMARK.json`` run by ``python3 -m
ocm_bench.run``.  Nothing here imports ``jax`` or the JAX package
``ocm_tpu``; ``reference.py`` imports nothing of ``ocm_tpu_torch``."""
