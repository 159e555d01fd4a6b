"""Streaming SIMCA: single-pass sufficient statistics (port of
``ocm_tpu/models/streaming.py``).

Calibration spectra are ingested once, batch by batch, into an O(L^2)
statistic (count, mean, centered scatter), and a full ``SIMCAModel`` is
fitted from the moments alone: no (N, L) matrix is ever resident, and a
batch costs one scatter product.

- ``SpectraMoments`` is an exact sufficient statistic for (mean,
  covariance).  Merging uses the pairwise (Chan et al.) update, stable
  under large common modes (no raw second moments are formed) and
  associative, so batches may arrive in any order.
- ``fit_simca_moments`` reproduces ``fit_simca`` for every statistic that
  is a function of (n, mean, covariance): loadings, eigenvalues, the T^2
  score covariance (cov(t) = P C P^T), the F/chi^2 T^2 limits, the
  theta-based Q limits and the 'sim'/'alt'/'ci' critical distances.
  Per-sample limit methods need the training scores and raise.

Every leaf may carry a leading class axis: ``moments_update_classes``
ingests a labelled batch into C statistics at once, the class axis written
out as a batch dimension (masks (C, B), scatter (C, L, L)), and
``fit_classes_moments`` fits the C models in one batched solve.  Centered
scatter products run in full f32 (``full_f32_matmul``).

``save_moments``/``load_moments`` read and write the JAX package's
msgpack file (``utils.msgpack_io``), so a statistic crosses between the
packages either way.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from ocm_tpu_torch._device import as_tensor, resolve_device
from ocm_tpu_torch.models.simca import SIMCAModel
from ocm_tpu_torch.ops.linalg import (deflated_thetas, eigh_desc_signed,
                                      full_f32_matmul, pca_topk_cov, pinv_psd)
from ocm_tpu_torch.stats import limits as L
from ocm_tpu_torch.utils import msgpack_io

MOMENT_T2_METHODS = ("Fdistrig", "Fdist", "chi2")
MOMENT_Q_METHODS = ("jm", "chi2box")
MOMENT_DECISION_TYPES = ("sim", "alt", "ci")


class SpectraMoments(NamedTuple):
    """Exact streaming sufficient statistic for (mean, covariance).

    ``scatter`` is the centered scatter sum_i (x_i - mean)(x_i - mean)^T, so
    covariance = scatter / (n - 1); ``n`` is a float count.  Each leaf may
    carry leading class axes.
    """

    n: torch.Tensor        # (...) float count
    mean: torch.Tensor     # (..., L)
    scatter: torch.Tensor  # (..., L, L)


def moments_init(length: int, dtype=torch.float32,
                 device=None) -> SpectraMoments:
    """Empty statistic, the identity of ``moments_merge`` (on CUDA unless
    ``device`` says otherwise)."""
    device = resolve_device(device)
    return SpectraMoments(
        n=torch.zeros((), dtype=dtype, device=device),
        mean=torch.zeros((length,), dtype=dtype, device=device),
        scatter=torch.zeros((length, length), dtype=dtype, device=device))


def moments_init_classes(n_classes: int, length: int, dtype=torch.float32,
                         device=None) -> SpectraMoments:
    """C stacked empty statistics (a class axis on every leaf)."""
    one = moments_init(length, dtype, device)
    return SpectraMoments(*(a.expand(n_classes, *a.shape).clone()
                            for a in one))


def _batch_moments(x, w, dt):
    """(count, mean, centered scatter) of the rows of ``x`` (B, L), each
    weighted by ``w`` (..., B) if given (0/1 masks or frequency weights;
    an all-zero ``w`` gives a count of 0 and contributes nothing)."""
    with full_f32_matmul():
        if w is None:
            nb = torch.tensor(float(x.shape[0]), dtype=dt, device=x.device)
            mu = x.mean(0)
            xc = x - mu
            return nb, mu, xc.T @ xc
        nb = w.sum(-1)
        safe = torch.where(nb > 0, nb, 1.0)
        mu = (w @ x) / safe[..., None]
        xc = (x - mu[..., None, :]) * torch.sqrt(w)[..., :, None]
        return nb, mu, xc.mT @ xc


def moments_update(mom: SpectraMoments, x, w=None) -> SpectraMoments:
    """Ingest one batch of spectra (rows of ``x``) into the statistic: one
    (L, B) x (B, L) product.  ``w`` ((B,) 0/1 or weights, or (..., B) for
    a statistic with class axes) masks rows; an all-zero ``w`` is an exact
    no-op."""
    dt, dev = mom.mean.dtype, mom.mean.device
    x = torch.as_tensor(x, dtype=dt, device=dev)
    if x.shape[0] == 0:
        return mom
    if w is not None:
        w = torch.as_tensor(w, dtype=dt, device=dev)
    return _merge(mom, SpectraMoments(*_batch_moments(x, w, dt)))


def moments_merge(a: SpectraMoments, b: SpectraMoments) -> SpectraMoments:
    """Combine two partial statistics (associative; pairwise/Chan update)."""
    return _merge(a, b)


def _merge(a: SpectraMoments, b: SpectraMoments) -> SpectraMoments:
    n = a.n + b.n
    safe_n = torch.where(n > 0, n, 1.0)
    delta = b.mean - a.mean
    mean = a.mean + delta * (b.n / safe_n)[..., None]
    coeff = (a.n * b.n / safe_n)[..., None, None]
    scatter = (a.scatter + b.scatter
               + coeff * (delta[..., :, None] * delta[..., None, :]))
    return SpectraMoments(n=n, mean=mean, scatter=scatter)


def moments_from(x, dtype=None, device=None) -> SpectraMoments:
    """One-shot statistic of a matrix (the same as ingesting it in one
    batch)."""
    x = as_tensor(x, device)
    return moments_update(moments_init(x.shape[1], dtype or x.dtype,
                                       x.device), x)


def moments_cov(mom: SpectraMoments):
    """np.cov(ddof=1) covariance of everything ingested."""
    denom = torch.where(mom.n > 1, mom.n - 1.0, 1.0)
    return mom.scatter / denom[..., None, None]


def moments_std(mom: SpectraMoments, ddof: int = 1):
    """Per-wavelength standard deviation of everything ingested."""
    denom = torch.where(mom.n > ddof, mom.n - ddof, 1.0)
    return torch.sqrt(torch.diagonal(mom.scatter, dim1=-2, dim2=-1)
                      / denom[..., None])


def moments_update_classes(moms: SpectraMoments, x, y,
                           class_labels: Sequence) -> SpectraMoments:
    """Ingest one labelled batch into C stacked per-class statistics at
    once (masks (C, B), one batched scatter product (C, L, L)).  Labels of
    ``y`` not in ``class_labels`` are ignored."""
    y = np.asarray(y)
    masks = np.stack([(y == c) for c in class_labels]).astype(np.float32)
    return moments_update(moms, x, w=masks)


def save_moments(path, mom: SpectraMoments) -> None:
    """Persist the statistic, the whole ingest state, so that a stream
    survives a restart: the JAX package's msgpack file (``{n, mean,
    scatter}``), byte-equal to the one it writes for the same arrays."""
    msgpack_io.save(path, {f: a.detach().cpu().numpy()
                           for f, a in mom._asdict().items()},
                    sort_keys=False)


def load_moments(path, length=None, device=None) -> SpectraMoments:
    """A statistic written by either package's ``save_moments``, on
    ``device`` (CUDA unless given).  ``length``, if given, is checked."""
    state = msgpack_io.load(path)
    stored = state["mean"].shape[-1]
    if length is not None and stored != length:
        raise ValueError(f"stored statistic is for L={stored} spectra, "
                         f"expected L={length}")
    device = resolve_device(device)
    return SpectraMoments(*(torch.as_tensor(state[f], device=device)
                            for f in SpectraMoments._fields))


def _validate_moment_methods(decision_type, t2_method, q_method):
    if t2_method not in MOMENT_T2_METHODS:
        raise ValueError(
            f"t2_method {t2_method!r} needs the per-sample training T^2 "
            "scores, which a streaming statistic does not retain; "
            f"moment-exact choices are {MOMENT_T2_METHODS} (or use "
            "fit_simca on the full matrix)")
    if q_method not in MOMENT_Q_METHODS:
        raise ValueError(
            f"q_method {q_method!r} needs the per-sample training Q "
            "scores, which a streaming statistic does not retain; "
            f"moment-exact choices are {MOMENT_Q_METHODS} (or use "
            "fit_simca on the full matrix)")
    if decision_type not in MOMENT_DECISION_TYPES:
        raise ValueError(
            f"decision_type {decision_type!r} is built on Pomerantsev "
            "moment matching of the training scores; streaming fits "
            f"support {MOMENT_DECISION_TYPES}")


def fit_simca_moments(mom: SpectraMoments, n_components: int,
                      decision_type: str = "alt", t2_method: str = "Fdist",
                      q_method: str = "jm", t2_cl: float = 0.95,
                      q_cl: float = 0.95, d_cl: float = 0.95,
                      solver: str = "eigh", oversample: int = 10,
                      subspace_iters: int = 4, omega=None) -> SIMCAModel:
    """Fit a SIMCA model (or C of them, for moments with a class axis) from
    a streaming statistic alone.

    ``solver='eigh'`` decomposes the (L, L) covariance densely (parity with
    ``fit_simca(solver='svd')``); ``'rsvd'`` is the GEMM-only path (parity
    with ``fit_simca(solver='rsvd')`` given the same test matrix ``omega``,
    by default the same seeded draw, provided the stream holds at least
    ``n_components + oversample + 1`` spectra).  The model's
    ``t2_train``/``q_train`` are empty: a streaming fit keeps no training
    scores.
    """
    _validate_moment_methods(decision_type, t2_method, q_method)
    if solver not in ("eigh", "rsvd"):
        raise ValueError(f"unknown solver {solver!r}; expected 'eigh' or"
                         " 'rsvd'")
    k = n_components
    length = mom.mean.shape[-1]
    dt, dev = mom.mean.dtype, mom.mean.device
    c = moments_cov(mom)
    if solver == "rsvd":
        s = min(k + oversample, length)
        eigenvalues, eigvecs = pca_topk_cov(c, s, iters=subspace_iters,
                                            omega=omega)
        thetas = deflated_thetas(c, eigenvalues, eigvecs, k)
    else:
        eigenvalues, eigvecs = eigh_desc_signed(c)
        # slots beyond the data rank are junk, as fit_simca's full-SVD
        # spectrum stops at min(n, L)
        max_rank = torch.minimum(mom.n, torch.tensor(float(length), dtype=dt,
                                                     device=dev))
        thetas = L.residual_thetas(eigenvalues, k, max_rank=max_rank)
    p = eigvecs[..., :k].mT
    # the training scores' covariance is exactly P C P^T (t is centered)
    with full_f32_matmul():
        invcovT = pinv_psd(p @ c @ p.mT)
    empty = torch.zeros((*mom.n.shape, 0), dtype=dt, device=dev)
    t2_res = L.t2_limit(empty, k, t2_method, t2_cl, n_samples=mom.n)
    q_res = L.q_limit(empty, q_method, q_cl, thetas=thetas)
    d_limit = L.critical_distance(decision_type, t2_res, q_res,
                                  n_components=k, thetas=thetas, dcl=d_cl)
    return SIMCAModel(
        mean=mom.mean, components=p, invcovT=invcovT,
        eigenvalues=eigenvalues, t2_res=t2_res, q_res=q_res, d_limit=d_limit,
        t2_train=empty, q_train=empty, n_samples=mom.n.to(torch.int64))


def fit_classes_moments(moms: SpectraMoments, n_components: int,
                        **kwargs) -> SIMCAModel:
    """Fit C stacked per-class models from stacked statistics in one
    batched solve (the streaming sibling of ``fit_classes``); the result
    feeds ``predict_classes`` and the serving scorer."""
    if moms.mean.dim() != 2:
        raise ValueError("fit_classes_moments takes statistics with a "
                         f"class axis; mean has shape {tuple(moms.mean.shape)}")
    return fit_simca_moments(moms, n_components, **kwargs)
