"""Device and dtype resolution for the port's entry points.

A numpy (or other non-tensor) input goes to ``device="cuda"`` unless the
caller names another device; a tensor input stays on its own device.
Asking for CUDA where there is none raises: nothing falls back quietly to
the CPU.

Float64 data that comes from the host (numpy, a CPU tensor, Python floats)
to a CUDA device with no explicit ``dtype=`` becomes float32 there
(``config.stats_dtype``), as the JAX package's accelerator computes with
x64 off; on the CPU it stays float64.  ``require_f32`` is the entry
points' refusal of a float64 request on CUDA where an f32-only kernel
would run.
"""

from __future__ import annotations

import numpy as np
import torch

from ocm_tpu_torch.config import stats_dtype


def resolve_device(device=None, like=None) -> torch.device:
    """The device an entry point runs on.

    ``device`` wins when given; otherwise a tensor ``like`` keeps its own
    device, and anything else goes to CUDA.
    """
    if device is None:
        device = like.device if isinstance(like, torch.Tensor) else "cuda"
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested (the default for non-tensor inputs) but "
            "torch.cuda.is_available() is False; pass device='cpu' or CPU "
            "tensors to run on the CPU")
    return device


def target_dtype(x, device: torch.device, dtype=None):
    """The dtype ``as_tensor`` gives ``x`` on ``device``: ``dtype`` when
    given, else x's own, except float64 host data bound for CUDA, which
    takes ``stats_dtype(device)`` (float32).  None means "x's own"."""
    if dtype is not None or device.type != "cuda":
        return dtype
    if isinstance(x, torch.Tensor):
        if x.is_cuda or x.dtype != torch.float64:
            return None
    elif np.asarray(x).dtype != np.float64:
        return None
    return stats_dtype(device)


def as_tensor(x, device=None, dtype=None) -> torch.Tensor:
    """``x`` as a tensor on the resolved device (see ``resolve_device``),
    in ``target_dtype``."""
    device = resolve_device(device, x)
    return torch.as_tensor(x, dtype=target_dtype(x, device, dtype),
                           device=device)


def require_f32(dtype, device, kernel: str, entry: str) -> None:
    """Refuse float64 on CUDA at ``entry``, where the f32-only ``kernel``
    would run."""
    if torch.device(device).type == "cuda" and dtype == torch.float64:
        raise ValueError(
            f"{entry}: float64 on CUDA is not supported: {kernel} takes "
            "float32 on the card.  Pass float32 tensors, or host (numpy or "
            "CPU) float64 data with no dtype=, which becomes float32 on the "
            "card, or run on the CPU (device='cpu'), where float64 stays")
