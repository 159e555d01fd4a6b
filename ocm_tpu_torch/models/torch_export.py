"""Export bundles to reference-format torch checkpoints (port of
``ocm_tpu/models/torch_export.py``).

The inverse of ``models.torch_import``: a bundle trained here serializes
to a ``state_dict`` that the reference's torch ``ConvVAE1D`` loads with
``strict=True``: weights, BatchNorm running statistics, and the registered
decision buffers ``threshold``/``threshold_q``/``threshold_h``/
``threshold_f``, ``spec_mean``/``spec_std`` and ``latent_mean``/
``latent_cov_inv`` (written as float32, as the reference registers them).
The bundle's state dict already has the reference's keys and torch's
layouts, so no weight is transposed, flipped or permuted; a BatchNorm step
counter (``num_batches_tracked``) is written as 0, as the JAX package
writes it.
"""

from __future__ import annotations

import numpy as np
import torch

from ocm_tpu_torch.models.bundle import OCMBundle
from ocm_tpu_torch.models.torch_import import BUFFERS
from ocm_tpu_torch.models.vae import ConvVAE1D


def numpy_state_dict_from_bundle(bundle: OCMBundle,
                                 model: ConvVAE1D) -> dict:
    """Reference ``state_dict`` keys -> numpy arrays, for one class's
    bundle of the architecture ``model`` (its keys are checked)."""
    expected = set(model.state_dict())
    if set(bundle.state_dict) != expected:
        raise ValueError(
            "bundle does not match the architecture: missing "
            f"{sorted(expected - set(bundle.state_dict))}, unexpected "
            f"{sorted(set(bundle.state_dict) - expected)}")
    if bundle.latent_mean.dim() != 1:
        raise ValueError("a class-stacked bundle holds several models; "
                         "export one class (bundle.class_slice)")
    state = {}
    for key, v in bundle.state_dict.items():
        a = v.detach().cpu().numpy()
        state[key] = (np.zeros_like(a) if key.endswith("num_batches_tracked")
                      else a)
    for name in BUFFERS:
        state[name] = getattr(bundle, name).detach().cpu().numpy().astype(
            np.float32)
    return state


def torch_state_dict_from_bundle(bundle: OCMBundle, model: ConvVAE1D):
    """Reference-format ``state_dict`` of CPU torch tensors."""
    return {k: torch.from_numpy(np.array(v)) for k, v in
            numpy_state_dict_from_bundle(bundle, model).items()}


def save_torch_checkpoint(path: str, bundle: OCMBundle,
                          model: ConvVAE1D) -> str:
    """Write a ``.pth`` the reference loads with
    ``ConvVAE1D(...).load_state_dict(torch.load(path), strict=True)``."""
    torch.save(torch_state_dict_from_bundle(bundle, model), path)
    return path
