"""Hand-written CUDA kernels and their plain PyTorch twins.

- ``t2q_scores_multiclass`` is the port of the TPU kernel
  ``t2_q_scores_pallas`` (``ocm_tpu/ops/kernels.py:45``) in its
  multi-class form: T^2 and Q of every spectrum against C SIMCA models,
  centering directly (``x - m_c``) in one read of the spectra
  (``ocm_tpu_torch/csrc/t2q_scores.cu``).
- ``reparam_kl`` is the port of ``reparam_loss_pallas`` with explicit
  noise (``ocm_tpu/ops/kernels.py:110``): ``z = mu + eps * exp(lv / 2)``
  and the per-sample KL (``ocm_tpu_torch/csrc/reparam_kl.cu``).
  ``fused_reparam_kl`` (``ocm_tpu/ops/kernels.py:192``) wraps it in a
  ``torch.autograd.Function`` with the analytic backward.

Each CUDA source says what bounds its kernel on the card and how the
design answers that.  On a CPU tensor a wrapper computes its plain twin
(``*_plain``); on a CUDA tensor it launches the kernel or raises, and never
falls back.  ``<wrapper>.launches`` counts the kernel's launches.
"""

from __future__ import annotations

import torch

from ocm_tpu_torch.ops import _build

_INT_MAX = 2 ** 31 - 1


def check_cuda_f32(what, tensors):
    """Raise unless every tensor of ``tensors`` ({name: (tensor, ndim)})
    is a contiguous float32 CUDA tensor of that rank on one device."""
    device = next(iter(tensors.values()))[0].device
    if device.type != "cuda":
        raise ValueError(f"{what} runs on CUDA or CPU tensors, not {device}")
    for name, (a, ndim) in tensors.items():
        if a.device != device:
            raise ValueError(f"{what}: {name} is on {a.device}, not {device}")
        if a.dtype != torch.float32:
            raise TypeError(f"{what}: the CUDA kernel takes float32 tensors; "
                            f"{name} is {a.dtype}")
        if a.dim() != ndim or not a.is_contiguous():
            raise ValueError(f"{what}: {name} must be a contiguous {ndim}-d "
                             f"tensor, got shape {tuple(a.shape)}")
        if a.numel() > _INT_MAX:
            raise ValueError(f"{what}: {name} exceeds int32 indexing")


def stream_of(x) -> int:
    """The current CUDA stream of ``x``'s device, as a pointer."""
    return torch.cuda.current_stream(x.device).cuda_stream


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


def t2q_scores_multiclass(x, means, components, invcovs):
    """Fused T^2/Q scoring of ``x`` (N, L) against C models at once.

    CPU tensors: the plain twin.  CUDA tensors (float32, contiguous): the
    hand-written kernel on the current stream.  Returns t2, q, each (C, N).
    """
    if x.device.type == "cpu":
        return t2q_scores_multiclass_plain(x, means, components, invcovs)
    check_cuda_f32("t2q_scores_multiclass", {
        "x": (x, 2), "means": (means, 2), "components": (components, 3),
        "invcovs": (invcovs, 3)})
    n, length = x.shape
    c, k, length_p = components.shape
    if (means.shape != (c, length) or length_p != length
            or invcovs.shape != (c, k, k) or k < 1):
        raise ValueError(
            f"shape mismatch: x {tuple(x.shape)}, means {tuple(means.shape)}, "
            f"components {tuple(components.shape)}, invcovs "
            f"{tuple(invcovs.shape)}")
    t2 = torch.empty((c, n), dtype=torch.float32, device=x.device)
    q = torch.empty_like(t2)
    if n == 0 or c == 0:
        return t2, q
    with torch.cuda.device(x.device):
        err = _build.library().t2q_scores_multiclass_f32(
            x.data_ptr(), means.data_ptr(), components.data_ptr(),
            invcovs.data_ptr(), t2.data_ptr(), q.data_ptr(),
            n, length, c, k, stream_of(x))
    _build.check(err, "t2q_scores_multiclass")
    t2q_scores_multiclass.launches += 1
    return t2, q


t2q_scores_multiclass.launches = 0


def reparam_kl_plain(mu, logvar, eps):
    """``z = mu + eps * exp(logvar / 2)`` and the per-sample
    ``kl = -1/2 * sum_j (1 + lv - mu^2 - e^lv)``, in plain PyTorch."""
    z = mu + eps * torch.exp(0.5 * logvar)
    kl = -0.5 * (1.0 + logvar - mu * mu - torch.exp(logvar)).sum(-1)
    return z, kl


def reparam_kl(mu, logvar, eps):
    """Reparameterize and per-sample KL of (N, k) ``mu``, ``logvar`` with
    the given noise ``eps``; returns z (N, k) and kl (N,).

    CPU tensors: the plain twin.  CUDA tensors (float32, contiguous): the
    hand-written kernel on the current stream.
    """
    if mu.device.type == "cpu":
        return reparam_kl_plain(mu, logvar, eps)
    check_cuda_f32("reparam_kl", {"mu": (mu, 2), "logvar": (logvar, 2),
                                  "eps": (eps, 2)})
    if logvar.shape != mu.shape or eps.shape != mu.shape:
        raise ValueError(f"shape mismatch: mu {tuple(mu.shape)}, logvar "
                         f"{tuple(logvar.shape)}, eps {tuple(eps.shape)}")
    n, k = mu.shape
    z = torch.empty_like(mu)
    kl = torch.empty((n,), dtype=torch.float32, device=mu.device)
    if n == 0 or k == 0:
        return z, kl.zero_()
    with torch.cuda.device(mu.device):
        err = _build.library().reparam_kl_f32(
            mu.data_ptr(), logvar.data_ptr(), eps.data_ptr(), z.data_ptr(),
            kl.data_ptr(), n, k, stream_of(mu))
    _build.check(err, "reparam_kl")
    reparam_kl.launches += 1
    return z, kl


reparam_kl.launches = 0


class _FusedReparamKL(torch.autograd.Function):
    """Forward: ``reparam_kl``.  Backward (``ocm_tpu/ops/kernels.py:212-218``),
    elementwise torch as in JAX, where it is jnp outside the kernel:
    dmu = dz + dkl * mu, dlv = dz * eps * e^(lv/2) / 2 - dkl * (1 - e^lv) / 2;
    eps gets no gradient."""

    @staticmethod
    def forward(ctx, mu, logvar, eps):
        z, kl = reparam_kl(mu, logvar, eps)
        ctx.save_for_backward(mu, logvar, eps)
        return z, kl

    @staticmethod
    def backward(ctx, dz, dkl):
        mu, logvar, eps = ctx.saved_tensors
        dkl = dkl[:, None]
        dmu = dz + dkl * mu
        dlv = (dz * 0.5 * eps * torch.exp(0.5 * logvar)
               - dkl * 0.5 * (1.0 - torch.exp(logvar)))
        return dmu, dlv, None


def fused_reparam_kl(mu, logvar, eps):
    """Differentiable ``reparam_kl``: returns (z, kl_per_sample)."""
    return _FusedReparamKL.apply(mu, logvar, eps)
