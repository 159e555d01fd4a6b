"""Device resolution for the port's entry points.

A numpy (or other non-tensor) input goes to ``device="cuda"`` unless the
caller names another device; a tensor input stays on its own device.
Asking for CUDA where there is none raises: nothing falls back quietly to
the CPU.
"""

from __future__ import annotations

import torch


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


def as_tensor(x, device=None, dtype=None) -> torch.Tensor:
    """``x`` as a tensor on the resolved device (see ``resolve_device``)."""
    return torch.as_tensor(x, dtype=dtype, device=resolve_device(device, x))
