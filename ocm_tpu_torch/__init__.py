"""PyTorch/CUDA port of ``ocm_tpu`` for NVIDIA Hopper GPUs.

The JAX package ``ocm_tpu`` stays the reference; each module here mirrors
its namesake there (``ops/linalg.py``, ``ops/special.py``,
``ops/kernels.py``, ``ops/bn.py``, ``stats/limits.py``,
``models/simca.py``, ``models/cv.py``, ``models/vae.py``,
``models/bundle.py``, ``models/trainer.py`` and the rest) and is held
against it by ``tests/test_torch_port_*.py``.  ``utils/msgpack_io.py``
reads and writes the JAX package's model files without flax.  The hand-written CUDA kernels live in
``csrc/`` and are built by ``ops/_build.py``.

This package imports ``torch``, ``numpy`` and the standard library only:
never ``jax`` and nothing of ``ocm_tpu``.  Entry points run on the CUDA
device unless the caller passes ``device="cpu"`` or CPU tensors; with no
GPU present they raise instead of falling back to the CPU.

Loading the package selects cuDNN's deterministic algorithms for the
process, as the reference's scripts do (``cudnn.deterministic = True``):
a training run, a calibration or a screen is then a pure function of its
inputs on a given card, and a stacked screen equals its single-class
screens bit for bit.  The setting is made once here and never toggled, so
threads that decide at the same time all see it.
"""

import torch

torch.backends.cudnn.deterministic = True
