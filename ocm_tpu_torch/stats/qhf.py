"""Pooled chi^2 "full distance" scorers for VAE one-class decisions (port of
``ocm_tpu/stats/qhf.py``).

1. ``compute_q_h_f`` of the reference: q = squared spectral residual,
   h = row leverage of the standardized latent of the scored batch itself,
   dofs moment-matched on that same batch (quirk Q3: scoring depends on the
   batch) -- ``qhf_batch``, with ``qhf_batch_host`` its numpy float64 twin
   for pinned deployment decisions; ``qhf_fit``/``qhf_calibrated`` freeze
   the statistics on the calibration set instead.
2. ``full_distance``: h = squared Euclidean distance of the latent mean to
   the calibration latent mean, moments taken on the scored set (quirk Q4,
   with the *biased* std) or frozen calibration moments.

Moments follow numpy: ``_moment_dof`` takes the unbiased std (ddof=1),
``full_distance`` the biased one.  ``chi2_ppf`` takes the non-integer dofs
the moment matching gives.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ocm_tpu_torch.ops.linalg import pinv_psd
from ocm_tpu_torch.ops.special import chi2_ppf


class QHFResult(NamedTuple):
    q: torch.Tensor
    h: torch.Tensor
    f: torch.Tensor
    q_crit: torch.Tensor
    h_crit: torch.Tensor
    f_crit: torch.Tensor


def _moment_dof(values):
    """N = 2 * (mean/std)^2 with the unbiased std; returns (N, mean)."""
    m = values.mean()
    s = values.std(correction=1)
    return 2.0 * (m / s) ** 2, m


def _leverage(z_std, gram_pinv):
    return ((z_std @ gram_pinv) * z_std).sum(-1)


def _leverage_from_batch(z, eps: float = 1e-12):
    """Row leverage h_i = diag(Z* (Z*^T Z*)^+ Z*^T)_i of the column-
    standardized batch Z* (the reference's sum of squared left singular
    vectors), through the (k, k) Gram pseudo-inverse."""
    z_std = (z - z.mean(0)) / (z.std(0, correction=1) + eps)
    return _leverage(z_std, pinv_psd(z_std.T @ z_std))


def qhf_stats(x, x_rec, z):
    """(q, h, f) of ``qhf_batch`` without its critical values: the
    statistics a decision against a stored ``threshold_f`` needs."""
    q = ((x - x_rec) ** 2).sum(1)
    nq, q0 = _moment_dof(q)
    h = _leverage_from_batch(z)
    nh, h0 = _moment_dof(h)
    return q, h, (h / h0) * nh + (q / q0) * nq


def qhf_batch(x, x_rec, z, cl: float = 0.95) -> QHFResult:
    """Reference-compatible ``compute_q_h_f``: every statistic (q0, Nq, h0,
    Nh and the critical values) from the batch being scored (quirk Q3)."""
    q, h, f = qhf_stats(x, x_rec, z)
    nq, nh = _moment_dof(q)[0], _moment_dof(h)[0]
    return QHFResult(q, h, f, chi2_ppf(cl, nq), chi2_ppf(cl, nh),
                     chi2_ppf(cl, nh + nq))


def qhf_batch_host(x_std, r_std, z):
    """Host numpy float64 twin of ``qhf_batch``'s statistics, for the
    deployment-pinned variant 'f': the decision is then a pure function of
    the network outputs, whatever computed them.  Returns ``(q, h, f)`` as
    float64 arrays."""
    x64, r64, z64 = (np.asarray(a, np.float64) for a in (x_std, r_std, z))
    q = np.sum((x64 - r64) ** 2, axis=1)
    nq, q0 = 2.0 * (q.mean() / q.std(ddof=1)) ** 2, q.mean()
    z_c = (z64 - z64.mean(axis=0)) / (z64.std(axis=0, ddof=1) + 1e-12)
    gram_pinv = np.linalg.pinv(z_c.T @ z_c, hermitian=True)
    h = np.einsum("ij,jk,ik->i", z_c, gram_pinv, z_c)
    nh, h0 = 2.0 * (h.mean() / h.std(ddof=1)) ** 2, h.mean()
    return q, h, (h / h0) * nh + (q / q0) * nq


class QHFCalibration(NamedTuple):
    """Frozen calibration statistics for the corrected q/h/f decision."""

    z_mean: torch.Tensor
    z_std: torch.Tensor
    gram_pinv: torch.Tensor
    q0: torch.Tensor
    nq: torch.Tensor
    h0: torch.Tensor
    nh: torch.Tensor
    q_crit: torch.Tensor
    h_crit: torch.Tensor
    f_crit: torch.Tensor


def qhf_fit(x_cal, x_rec_cal, z_cal, cl: float = 0.95) -> QHFCalibration:
    """Fit frozen q/h/f statistics on the calibration set (corrected Q3)."""
    q = ((x_cal - x_rec_cal) ** 2).sum(1)
    nq, q0 = _moment_dof(q)
    z_mean = z_cal.mean(0)
    z_sd = z_cal.std(0, correction=1) + 1e-12
    z_std = (z_cal - z_mean) / z_sd
    gram_pinv = pinv_psd(z_std.T @ z_std)
    nh, h0 = _moment_dof(_leverage(z_std, gram_pinv))
    return QHFCalibration(z_mean, z_sd, gram_pinv, q0, nq, h0, nh,
                          chi2_ppf(cl, nq), chi2_ppf(cl, nh),
                          chi2_ppf(cl, nh + nq))


def qhf_calibrated(x, x_rec, z, calib: QHFCalibration) -> QHFResult:
    """Score new samples against frozen calibration statistics."""
    q = ((x - x_rec) ** 2).sum(1)
    h = _leverage((z - calib.z_mean) / calib.z_std, calib.gram_pinv)
    f = (h / calib.h0) * calib.nh + (q / calib.q0) * calib.nq
    return QHFResult(q, h, f, calib.q_crit, calib.h_crit, calib.f_crit)


class FullDistanceResult(NamedTuple):
    f: torch.Tensor
    f_crit: torch.Tensor
    nh: torch.Tensor
    nq: torch.Tensor


def full_distance(mu, latent_mean, q_errors, alpha: float = 0.05,
                  moments=None) -> FullDistanceResult:
    """The final_vaesimca full-distance decision: h = ||mu - latent_mean||^2,
    q = the spectral reconstruction errors, dofs moment-matched on the
    scored set with the biased std (``moments=None``, quirk Q4) or from
    ``moments=(h0, sh, q0, sq)`` frozen on calibration.  Accept when
    f <= f_crit."""
    h = ((mu - latent_mean[None, :]) ** 2).sum(1)
    q = q_errors
    if moments is None:
        h0, sh = h.mean(), h.std(correction=0)
        q0, sq = q.mean(), q.std(correction=0)
    else:
        h0, sh, q0, sq = (torch.as_tensor(m, dtype=h.dtype, device=h.device)
                          for m in moments)
    nh = 2.0 * (h0 / sh) ** 2
    nq = 2.0 * (q0 / sq) ** 2
    f = h / h0 * nh + q / q0 * nq
    return FullDistanceResult(f, chi2_ppf(1.0 - alpha, nh + nq), nh, nq)
