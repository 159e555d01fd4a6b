"""Hand-written CUDA kernels and their plain PyTorch twins.

``t2q_scores_multiclass`` is the port of the TPU kernel
``t2_q_scores_pallas`` (``ocm_tpu/ops/kernels.py:45``) in its multi-class
form: T^2 and Q of every spectrum against C SIMCA models, centering
directly (``x - m_c``) in one read of the spectra.  Its CUDA source,
``ocm_tpu_torch/csrc/t2q_scores.cu``, says what bounds it on the card and
how the design answers that.

On a CPU tensor the wrapper computes the plain twin
``t2q_scores_multiclass_plain``; on a CUDA tensor it launches the kernel
or raises, and never falls back.  ``t2q_scores_multiclass.launches``
counts the kernel's launches.
"""

from __future__ import annotations

import torch

from ocm_tpu_torch.ops import _build

_INT_MAX = 2 ** 31 - 1


def t2q_scores_multiclass_plain(x, means, components, invcovs):
    """T^2 and Q of ``x`` (N, L) against C models, in plain PyTorch.

    means (C, L), components (C, k, L), invcovs (C, k, k); f32 or f64.
    Returns t2 (C, N) and q (C, N).
    """
    xc = x[None, :, :] - means[:, None, :]                 # (C, N, L)
    t = xc @ components.mT                                 # (C, N, k)
    t2 = ((t @ invcovs) * t).sum(-1)
    q = ((xc * xc).sum(-1) - (t * t).sum(-1)).clamp_min(0.0)
    return t2, q


def _check_cuda_inputs(x, means, components, invcovs):
    if x.device.type != "cuda":
        raise ValueError(f"t2q_scores_multiclass runs on CUDA or CPU tensors, "
                         f"not {x.device}")
    for name, a, ndim in (("x", x, 2), ("means", means, 2),
                          ("components", components, 3),
                          ("invcovs", invcovs, 3)):
        if a.device != x.device:
            raise ValueError(f"{name} is on {a.device}, x on {x.device}")
        if a.dtype != torch.float32:
            raise TypeError(f"the CUDA kernel takes float32 tensors; {name} "
                            f"is {a.dtype}")
        if a.dim() != ndim or not a.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {ndim}-d tensor, "
                             f"got shape {tuple(a.shape)}")
    n, length = x.shape
    c, k, length_p = components.shape
    if (means.shape != (c, length) or length_p != length
            or invcovs.shape != (c, k, k) or k < 1):
        raise ValueError(
            f"shape mismatch: x {tuple(x.shape)}, means {tuple(means.shape)}, "
            f"components {tuple(components.shape)}, invcovs "
            f"{tuple(invcovs.shape)}")
    if max(n, c * k * length) > _INT_MAX:
        raise ValueError("t2q_scores_multiclass: sizes exceed int32")


def t2q_scores_multiclass(x, means, components, invcovs):
    """Fused T^2/Q scoring of ``x`` (N, L) against C models at once.

    CPU tensors: the plain twin.  CUDA tensors (float32, contiguous): the
    hand-written kernel on the current stream.  Returns t2, q, each (C, N).
    """
    if x.device.type == "cpu":
        return t2q_scores_multiclass_plain(x, means, components, invcovs)
    _check_cuda_inputs(x, means, components, invcovs)
    n, length = x.shape
    c, k, _ = components.shape
    t2 = torch.empty((c, n), dtype=torch.float32, device=x.device)
    q = torch.empty_like(t2)
    if n == 0 or c == 0:
        return t2, q
    lib = _build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.t2q_scores_multiclass_f32(
            x.data_ptr(), means.data_ptr(), components.data_ptr(),
            invcovs.data_ptr(), t2.data_ptr(), q.data_ptr(),
            n, length, c, k, stream)
    if err != 0:
        raise RuntimeError(f"t2q_scores_multiclass: CUDA error {err} "
                           f"({lib.t2q_error_string(err).decode()})")
    t2q_scores_multiclass.launches += 1
    return t2, q


t2q_scores_multiclass.launches = 0
