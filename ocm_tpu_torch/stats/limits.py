"""Acceptance-limit engines for one-class models (port of ``ocm_tpu/stats/limits.py``).

- Hotelling T^2 limits: 'perc', 'Fdistrig', 'Fdist', 'chi2', 'chi2pom'
- Q residual limits:    'perc', 'jm' (Jackson-Mudholkar), 'chi2box',
                        'chi2pom' (Pomerantsev moment-matched chi^2)
- combined critical distance per decision type: 'sim', 'alt', 'ci', 'dd'

Every function broadcasts over leading (class) dimensions: statistics are
``(..., n)`` and limits ``(...)``, where the JAX package vmaps.  Quantiles
run on the statistics' own device (``ocm_tpu_torch.ops.special``).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ocm_tpu_torch.ops.special import chi2_ppf, erfinv, f_ppf

T2_METHODS = ("perc", "Fdistrig", "Fdist", "chi2", "chi2pom")
Q_METHODS = ("perc", "jm", "chi2box", "chi2pom")
DECISION_TYPES = ("sim", "alt", "ci", "dd")


class LimitResult(NamedTuple):
    """An acceptance limit plus the moment-matching state 'dd' needs.

    ``dof``/``scale`` are only meaningful for 'chi2pom'; they are 1.0
    otherwise, with the limit's shape, so stacked models keep one layout.
    """

    limit: torch.Tensor
    dof: torch.Tensor
    scale: torch.Tensor


def _ones(lim):
    return LimitResult(lim, torch.ones_like(lim), torch.ones_like(lim))


def _pom_dof(values):
    """Pomerantsev moment-matched chi^2 dof: max(round(2*m^2/var), 1).

    ``torch.round`` rounds half to even, as NumPy and ``jnp.round`` do.
    """
    m = values.mean(-1)
    var = values.var(-1, correction=1)
    dof = torch.where(var > 0, torch.round(2.0 * (m * m) / var), 1.0)
    return dof.clamp_min(1.0), m


def _chi2pom(values, cl):
    dof, scale = _pom_dof(values)
    return LimitResult(scale * chi2_ppf(cl, dof) / dof, dof, scale)


def quantile(values, q):
    """The q-quantile over the last axis, linearly interpolated
    (``jnp.percentile(values, 100 q)``)."""
    return torch.quantile(values, q, dim=-1, interpolation="linear")


def t2_limit(t2, n_components, method: str = "Fdist", cl: float = 0.95,
             n_samples=None) -> LimitResult:
    """Hotelling T^2 acceptance limit over the last axis of ``t2``.

    ``n_components`` and ``n_samples`` (default: the length of that axis)
    are ints or tensors that broadcast to the batch shape ``t2.shape[:-1]``
    (masked fits carry a per-fold count and a per-cell k).
    """
    if method not in T2_METHODS:
        raise ValueError(f"unknown t2 limit method {method!r}")
    shape, kw = t2.shape[:-1], dict(dtype=t2.dtype, device=t2.device)
    n = torch.as_tensor(t2.shape[-1] if n_samples is None else n_samples,
                        **kw).expand(shape)
    k = torch.as_tensor(n_components, **kw).expand(shape)

    if method == "perc":
        return _ones(quantile(t2, cl))
    if method == "Fdistrig":
        fval = f_ppf(cl, k, n - k)
        return _ones((k / n) * (n * n - 1.0) / (n - k) * fval)
    if method == "Fdist":
        fval = f_ppf(cl, k, n - k)
        return _ones(k * (n - 1.0) / (n - k) * fval)
    if method == "chi2":
        return _ones(chi2_ppf(cl, k))
    return _chi2pom(t2, cl)


def _per_batch(v):
    """``v`` against a trailing axis: a tensor of the batch shape gains a
    last axis of 1; an int stays as it is."""
    return v[..., None] if isinstance(v, torch.Tensor) else v


def residual_thetas(eigenvalues, n_components, max_rank=None):
    """theta_m = sum of the m-th powers of the residual eigenvalues.

    The slice beyond ``n_components`` is a mask over the last axis;
    ``max_rank`` masks out padded eigenvalue slots.  Each is an int or a
    tensor of the batch shape (a fold's effective rank, a cell's k).
    """
    idx = torch.arange(eigenvalues.shape[-1], device=eigenvalues.device)
    mask = idx >= _per_batch(n_components)
    if max_rank is not None:
        mask = mask & (idx < _per_batch(max_rank))
    e = torch.where(mask, eigenvalues, 0.0)
    return e.sum(-1), (e * e).sum(-1), (e * e * e).sum(-1)


def q_limit(q, method: str = "jm", cl: float = 0.95, thetas=None) -> LimitResult:
    """Q residual acceptance limit over the last axis of ``q``.

    'jm' and 'chi2box' need the residual eigenvalue moments: pass
    ``thetas = residual_thetas(eigenvalues, n_components)``.
    """
    if method not in Q_METHODS:
        raise ValueError(f"unknown q limit method {method!r}")
    if method == "perc":
        return _ones(quantile(q, cl))
    if method == "jm":
        return _ones(jm_limit(thetas, cl))
    if method == "chi2box":
        theta1, theta2, _ = thetas
        g = theta2 / theta1
        ng = (theta1 * theta1) / theta2
        return _ones(g * chi2_ppf(cl, ng))
    return _chi2pom(q, cl)


def jm_limit(thetas, cl: float = 0.95):
    """Jackson-Mudholkar Q limit from residual eigenvalue moments, with the
    reference's h0 >= 0.001 clamp and the theta1 == 0 -> 0 short-circuit."""
    theta1, theta2, theta3 = thetas
    safe1 = torch.where(theta1 > 0, theta1, 1.0)
    safe2 = torch.where(theta2 > 0, theta2, 1.0)
    h0 = 1.0 - (2.0 * theta1 * theta3) / (3.0 * safe2 * safe2)
    h0 = h0.clamp_min(0.001)
    ca = math.sqrt(2.0) * erfinv(torch.tensor(2.0 * cl - 1.0, dtype=theta1.dtype,
                                              device=theta1.device))
    h1 = ca * torch.sqrt(2.0 * theta2 * h0 * h0) / safe1
    h2 = theta2 * h0 * (h0 - 1.0) / (safe1 * safe1)
    lim = theta1 * (h1 + 1.0 + h2) ** (1.0 / h0)
    return torch.where(theta1 > 0, lim, 0.0)


def critical_distance(decision_type: str, t2: LimitResult, q: LimitResult,
                      n_components=None, thetas=None, dcl: float = 0.95):
    """Combined decision boundary: 'sim' -> 1; 'alt' -> sqrt(2); 'ci' ->
    chi^2 of the trace-combined g/h; 'dd' -> chi^2 with the pooled
    Pomerantsev dofs.  Shaped like the limits."""
    if decision_type == "sim":
        return torch.ones_like(t2.limit)
    if decision_type == "alt":
        return torch.full_like(t2.limit, math.sqrt(2.0))
    if decision_type == "ci":
        theta1, theta2, _ = thetas
        k = torch.as_tensor(n_components, dtype=t2.limit.dtype,
                            device=t2.limit.device)
        tr1 = k / t2.limit + theta1 / q.limit
        tr2 = k / (t2.limit * t2.limit) + theta2 / (q.limit * q.limit)
        gd = tr2 / tr1
        hd = (tr1 * tr1) / tr2
        return gd * chi2_ppf(dcl, hd)
    if decision_type == "dd":
        return chi2_ppf(dcl, t2.dof + q.dof)
    raise ValueError(f"unknown decision type {decision_type!r}")


def reduced_distance(decision_type: str, t2, q, t2_res: LimitResult,
                     q_res: LimitResult):
    """Combined reduced distance per sample.

    ``t2``/``q`` are ``(..., N)``; the limits ``(...)`` broadcast over the
    trailing sample axis.
    """
    t2l, t2d, t2s, ql, qd, qs = (v[..., None] for v in (*t2_res, *q_res))
    if decision_type == "sim":
        return torch.maximum(t2 / t2l, q / ql)
    if decision_type == "alt":
        return torch.sqrt((t2 / t2l) ** 2 + (q / ql) ** 2)
    if decision_type == "ci":
        return t2 / t2l + q / ql
    if decision_type == "dd":
        return t2d * t2 / t2s + qd * q / qs
    raise ValueError(f"unknown decision type {decision_type!r}")
