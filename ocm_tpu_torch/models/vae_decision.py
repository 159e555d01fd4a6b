"""VAE one-class decisions, variants 2-4 (port of
``ocm_tpu/models/vae_decision.py``).

2. latent D^2 against a percentile threshold            (``decide_d2``)
3. latent D^2 AND the spectral Q                         (``decide_d2_q``)
4. the pooled chi^2 f distance, two flavours             (``decide_f``,
   ``decide_full_distance``)

``fit_thresholds`` is the reference's best-epoch calibration pass: latent
mean and inverse covariance (covariance + 1e-6 I), D^2 and Q thresholds at
the 95th percentile (linear interpolation, as ``jnp.percentile``), and the
h/f critical values of ``compute_q_h_f`` on the calibration set.

The reference samples z even in its eval-mode calibration forward: pass
``rng``, a CPU ``torch.Generator``, to reproduce that; one 64-bit seed is
drawn from it per forward and kernel K5 draws the noise on the card.  The
default (no ``rng``) scores through mu.  ``eps=`` passes the noise itself
(the tests hand both packages the same draws).

Every entry point runs on ``bundle.bind(model, bundle)`` under
``torch.inference_mode()``, on the bundle's device: numpy inputs go there.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ocm_tpu_torch._device import as_tensor
from ocm_tpu_torch.models.bundle import (OCMBundle, _on_bundle, decode,
                                         encode, forward, inference_entry,
                                         standardize)
from ocm_tpu_torch.models.vae import ConvVAE1D
from ocm_tpu_torch.ops.linalg import mahalanobis_sq, pinv_psd
from ocm_tpu_torch.stats.limits import quantile
from ocm_tpu_torch.stats.qhf import (full_distance, qhf_batch,
                                     qhf_calibrated, qhf_stats)


@inference_entry
def latent_d2(model: ConvVAE1D, bundle: OCMBundle, x):
    """Squared Mahalanobis distance of the encoder's mu to the calibration
    latent distribution."""
    mu, _ = encode(model, bundle, x)
    return mahalanobis_sq(mu, bundle.latent_mean, bundle.latent_cov_inv)


@inference_entry
def reconstruction_errors(model: ConvVAE1D, bundle: OCMBundle, x,
                          loss_type: str = "cosine", rng=None, eps=None):
    """Per-sample squared spectral reconstruction error Q: (q, mu, x_rec).

    BCE models compare in per-sample min-max-scaled space, other losses in
    raw spectral space.  ``rng`` (or ``eps``) switches to the reference's
    stochastic forward.
    """
    x = _on_bundle(bundle, x)
    if rng is None and eps is None:
        mu, _ = encode(model, bundle, x)
        x_rec = decode(model, bundle, mu)
    else:
        x_rec, mu, _ = forward(model, bundle, x, rng=rng, eps=eps)
    if loss_type in ("bce", "bce_prob"):
        x_min = x.min(1, keepdim=True).values
        x_max = x.max(1, keepdim=True).values

        def scale(v):
            return ((v - x_min) / (x_max - x_min + 1e-8)).clamp(0.0, 1.0)

        diff = scale(x) - scale(x_rec)
    else:
        diff = x - x_rec
    return (diff * diff).sum(1), mu, x_rec


def compute_rec_error(x, x_rec, mode: str = "euclidean", device=None):
    """Per-sample reconstruction error: 'euclidean' = squared L2; 'cosine'
    = chord distance sqrt(2 (1 - cos))."""
    x = as_tensor(x, device)
    x_rec = torch.as_tensor(x_rec, dtype=x.dtype, device=x.device)
    if mode == "euclidean":
        return ((x - x_rec) ** 2).sum(1)
    if mode == "cosine":
        xn = x / torch.linalg.vector_norm(x, dim=1, keepdim=True).clamp_min(
            1e-12)
        rn = x_rec / torch.linalg.vector_norm(
            x_rec, dim=1, keepdim=True).clamp_min(1e-12)
        return torch.sqrt(2.0 * (1.0 - (xn * rn).sum(1)))
    raise ValueError(
        f"unknown mode {mode!r}, choose 'euclidean' or 'cosine'")


@inference_entry
def fit_thresholds(model: ConvVAE1D, bundle: OCMBundle, x_cal,
                   loss_type: str = "cosine", percentile: float = 95.0,
                   rng=None, x_threshold=None, eps=None) -> OCMBundle:
    """Best-epoch calibration pass: returns the bundle with the latent
    statistics and all four thresholds set.

    ``x_threshold`` (a corrective option the reference lacks): the latent
    statistics come from ``x_cal``, the D^2/Q percentile thresholds from
    these spectra (held-out objects of the class).  With ``rng`` each of
    the two passes draws its own seed; ``eps`` is the noise of the
    ``x_cal`` pass and cannot be combined with ``x_threshold``.
    """
    if eps is not None and x_threshold is not None:
        raise ValueError("eps is the noise of the x_cal pass; with "
                         "x_threshold pass rng instead")
    x_cal = _on_bundle(bundle, x_cal)
    q_err, mu, x_rec = reconstruction_errors(model, bundle, x_cal, loss_type,
                                             rng=rng, eps=eps)
    latent_mean = mu.mean(0)
    muc = mu - latent_mean[None, :]
    cov = (muc.T @ muc) / (mu.shape[0] - 1) + 1e-6 * torch.eye(
        mu.shape[1], dtype=mu.dtype, device=mu.device)
    cov_inv = pinv_psd(cov)
    if x_threshold is not None:
        q_err, mu_thr, _ = reconstruction_errors(
            model, bundle, x_threshold, loss_type, rng=rng)
        d2 = mahalanobis_sq(mu_thr, latent_mean, cov_inv)
    else:
        d2 = mahalanobis_sq(mu, latent_mean, cov_inv)
    res = qhf_batch(standardize(bundle, x_cal), standardize(bundle, x_rec),
                    mu)
    return bundle._replace(
        latent_mean=latent_mean, latent_cov_inv=cov_inv,
        threshold=quantile(d2, percentile / 100.0),
        threshold_q=quantile(q_err, percentile / 100.0),
        threshold_h=res.h_crit, threshold_f=res.f_crit)


class VAEDecision(NamedTuple):
    accept: torch.Tensor        # bool per sample
    d2: torch.Tensor
    q: torch.Tensor


@inference_entry
def decide_d2(model: ConvVAE1D, bundle: OCMBundle, x) -> VAEDecision:
    """Variant 2: D^2 <= threshold."""
    d2 = latent_d2(model, bundle, x)
    return VAEDecision(d2 <= bundle.threshold, d2, torch.zeros_like(d2))


@inference_entry
def decide_d2_q(model: ConvVAE1D, bundle: OCMBundle, x,
                loss_type: str = "cosine") -> VAEDecision:
    """Variant 3: (D^2 <= threshold) AND (q <= threshold_q)."""
    q, mu, _ = reconstruction_errors(model, bundle, x, loss_type)
    d2 = mahalanobis_sq(mu, bundle.latent_mean, bundle.latent_cov_inv)
    return VAEDecision((d2 <= bundle.threshold) & (q <= bundle.threshold_q),
                       d2, q)


@inference_entry
def decide_f(model: ConvVAE1D, bundle: OCMBundle, x,
             calibration=None) -> VAEDecision:
    """Variant 4, ``compute_q_h_f`` flavour: f <= threshold_f.

    By default q0/Nq/h0/Nh are moment-matched on the batch being scored
    (quirk Q3); a ``QHFCalibration`` from ``stats.qhf.qhf_fit`` freezes
    them.  The batch's critical values are not computed: the decision
    compares with the stored ``threshold_f``.
    """
    mu, _ = encode(model, bundle, x)
    x_rec = decode(model, bundle, mu)
    return f_decision(bundle, standardize(bundle, x),
                      standardize(bundle, x_rec), mu, calibration)


def f_decision(bundle: OCMBundle, x_std, r_std, mu,
               calibration=None) -> VAEDecision:
    """``decide_f``'s statistics and decision from the network's outputs
    over the scored batch (standardized spectra and reconstructions, mu)."""
    if calibration is None:
        q, h, f = qhf_stats(x_std, r_std, mu)
    else:
        q, h, f = qhf_calibrated(x_std, r_std, mu, calibration)[:3]
    return VAEDecision(f <= bundle.threshold_f, h, q)


@inference_entry
def decide_full_distance(model: ConvVAE1D, bundle: OCMBundle, x,
                         alpha: float = 0.05,
                         moments=None) -> VAEDecision:
    """Variant 4, final_vaesimca flavour: Euclidean latent h plus spectral
    q with moment-matched dofs; accept when f <= chi2_{1-alpha}(Nh + Nq).
    ``moments=None`` takes the moments from the scored set (quirk Q4);
    pass calibration moments ``(h0, sh, q0, sq)`` to correct it."""
    q, mu, _ = reconstruction_errors(model, bundle, x, "euclidean")
    return full_distance_decision(bundle, q, mu, alpha, moments)


def full_distance_decision(bundle: OCMBundle, q, mu, alpha: float = 0.05,
                           moments=None) -> VAEDecision:
    """``decide_full_distance``'s decision from the scored batch's Q and mu."""
    res = full_distance(mu, bundle.latent_mean, q, alpha=alpha,
                        moments=moments)
    return VAEDecision(res.f <= res.f_crit,
                       ((mu - bundle.latent_mean) ** 2).sum(1), q)
