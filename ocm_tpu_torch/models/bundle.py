"""OCMBundle: one deployable one-class VAE model.

Port of ``ocm_tpu/models/bundle.py``: the network's state dict plus the
decision state the reference registers as buffers on its torch module:
per-wavelength standardization (``spec_mean``/``spec_std``), the latent
mean and inverse covariance, and the D^2/Q/h/f thresholds.  The functions
take the architecture (a ``ConvVAE1D``) and a bundle; they load the
bundle's state dict into the module and run it in eval mode on the
bundle's device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ocm_tpu_torch.models.vae import ConvVAE1D


class OCMBundle(NamedTuple):
    """Network state dict + preprocessing + decision state."""

    state_dict: dict
    spec_mean: torch.Tensor       # (L,) per-wavelength mean
    spec_std: torch.Tensor        # (L,) per-wavelength std
    latent_mean: torch.Tensor     # (k,)
    latent_cov_inv: torch.Tensor  # (k, k)
    threshold: torch.Tensor       # D^2 threshold (scalar)
    threshold_q: torch.Tensor     # Q threshold
    threshold_h: torch.Tensor     # h threshold
    threshold_f: torch.Tensor     # f threshold


def new_bundle(state_dict, spec_mean, spec_std, latent_dim: int) -> OCMBundle:
    """Fresh bundle with identity latent stats and zero thresholds."""
    mean = torch.as_tensor(spec_mean)
    std = torch.as_tensor(spec_std, dtype=mean.dtype, device=mean.device)
    zero = torch.zeros((), dtype=mean.dtype, device=mean.device)
    return OCMBundle(
        state_dict=state_dict, spec_mean=mean, spec_std=std,
        latent_mean=torch.zeros(latent_dim, dtype=mean.dtype,
                                device=mean.device),
        latent_cov_inv=torch.eye(latent_dim, dtype=mean.dtype,
                                 device=mean.device),
        threshold=zero, threshold_q=zero.clone(), threshold_h=zero.clone(),
        threshold_f=zero.clone())


def _on_bundle(bundle: OCMBundle, x):
    return torch.as_tensor(x, dtype=bundle.spec_mean.dtype,
                           device=bundle.spec_mean.device)


def standardize(bundle: OCMBundle, x):
    """(x - spec_mean) / spec_std."""
    return (_on_bundle(bundle, x) - bundle.spec_mean) / bundle.spec_std


def unstandardize(bundle: OCMBundle, x_std):
    """x_std * spec_std + spec_mean."""
    return _on_bundle(bundle, x_std) * bundle.spec_std + bundle.spec_mean


def _eval_model(model: ConvVAE1D, bundle: OCMBundle) -> ConvVAE1D:
    model.load_state_dict(bundle.state_dict)
    return model.eval()


def encode(model: ConvVAE1D, bundle: OCMBundle, x):
    """Raw spectra -> (mu, logvar), eval mode (standardization included)."""
    return _eval_model(model, bundle).encode(standardize(bundle, x))


def decode(model: ConvVAE1D, bundle: OCMBundle, z):
    """Latent -> raw spectra, eval mode (unstandardization included)."""
    return unstandardize(bundle, _eval_model(model, bundle).decode(
        _on_bundle(bundle, z)))


def forward(model: ConvVAE1D, bundle: OCMBundle, x, eps):
    """Full VAE forward on raw spectra with the noise ``eps``:
    (x_rec raw, mu, logvar)."""
    x_rec_std, mu, logvar = _eval_model(model, bundle)(
        standardize(bundle, x), _on_bundle(bundle, eps))
    return unstandardize(bundle, x_rec_std), mu, logvar


def reconstruct(model: ConvVAE1D, bundle: OCMBundle, x):
    """Deterministic reconstruction through mu: (x_rec raw, mu)."""
    mu, _ = encode(model, bundle, x)
    return decode(model, bundle, mu), mu


def spectral_stats(x_train):
    """Per-wavelength mean/std of the calibration set with the reference's
    additive 1e-12 guard (numpy in, numpy out; tensors stay tensors)."""
    if isinstance(x_train, torch.Tensor):
        return x_train.mean(0), x_train.std(0, correction=0) + 1e-12
    x = np.asarray(x_train)
    return x.mean(axis=0), x.std(axis=0) + 1e-12
