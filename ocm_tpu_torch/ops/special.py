"""Statistical special functions on tensors (port of ``ocm_tpu/ops/special.py``).

The limit engines invert the F and chi^2 distributions inside batched
fits, so the quantiles are computed on the tensor's own device: guarded
bisection plus bracket-clamped Newton polish (``_bisect``), with the same
36 bisection and 10 Newton steps as the reference, as fixed-count loops
that never read a value back to the host.

``torch.special`` has ``gammainc``, ``gammaln`` and ``erfinv`` but no
regularized incomplete beta, so ``betainc`` is written here as a
fixed-iteration modified-Lentz continued fraction with the symmetry swap.
"""

from __future__ import annotations

import torch
from torch.special import erfinv as erfinv  # noqa: PLC0414
from torch.special import gammainc, gammaln

_BISECT_ITERS = 36
_NEWTON_ITERS = 10
# Continued-fraction terms: measured in f64, the Lentz steps reach 1e-14 of
# 1 after ~1.1*sqrt(max(a, b)) terms (11 at the bench's a=5, b=345; 78 at
# a=b=5000), so 200 covers max(a, b) up to ~3e4, i.e. F dofs up to 6e4.
# This is the fixed count JAX's own betainc uses in f32.
_CF_ITERS = 200


def _float_tensors(*xs):
    """Broadcast ``xs`` to float tensors on the device of the first tensor.

    The dtype is the promoted float type of the tensor arguments (float64
    when none is a float tensor), as ``jnp.result_type(..., float)`` gives
    under x64.
    """
    tensors = [x for x in xs if isinstance(x, torch.Tensor)]
    device = tensors[0].device if tensors else torch.device("cpu")
    dtype = torch.float64
    floats = [t.dtype for t in tensors if t.dtype.is_floating_point]
    if floats:
        dtype = floats[0]
        for d in floats[1:]:
            dtype = torch.promote_types(dtype, d)
    return torch.broadcast_tensors(
        *(torch.as_tensor(x, dtype=dtype, device=device) for x in xs))


def _bisect(fn, p, lo, hi, iters: int = _BISECT_ITERS, logpdf=None,
            newton_iters: int = _NEWTON_ITERS):
    """Solve fn(x) = p for x in [lo, hi]; fn monotone increasing in x.

    ``logpdf(x)`` (log of fn') enables Newton polishing: steps are clamped
    into the maintained bracket, so convergence stays unconditional.
    """
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        below = fn(mid) < p
        lo, hi = torch.where(below, mid, lo), torch.where(below, hi, mid)
    x = 0.5 * (lo + hi)
    if logpdf is None:
        return x
    for _ in range(newton_iters):
        f = fn(x) - p
        x_new = x - f * torch.exp(-logpdf(x))
        # keep the bracket consistent and fall back to its midpoint when
        # Newton escapes (pdf ~ 0 in extreme tails)
        lo = torch.where(f < 0, x, lo)
        hi = torch.where(f >= 0, x, hi)
        bad = (~torch.isfinite(x_new)) | (x_new <= lo) | (x_new >= hi)
        x = torch.where(bad, 0.5 * (lo + hi), x_new)
    return x


def _betacf(a, b, x, iters: int = _CF_ITERS):
    """Continued fraction of I_x(a, b) (DLMF 8.17.22) by modified Lentz.

    Converges fast for x < (a + 1) / (a + b + 2); ``betainc`` swaps the
    arguments to stay there.  The partial numerators of all ``iters``
    steps are formed at once; the recurrence itself is sequential.
    """
    fin = torch.finfo(x.dtype)
    fpmin = fin.tiny / fin.eps
    m = torch.arange(1, iters + 1, dtype=x.dtype, device=x.device)
    a_, b_, x_ = a[..., None], b[..., None], x[..., None]
    m2 = 2.0 * m
    odd = m * (b_ - m) * x_ / ((a_ - 1.0 + m2) * (a_ + m2))
    even = -(a_ + m) * (a_ + b_ + m) * x_ / ((a_ + m2) * (a_ + 1.0 + m2))

    def guard(v):
        return torch.where(v.abs() < fpmin, fpmin, v)

    one = torch.ones_like(x)
    c = one
    d = guard(1.0 - (a + b) * x / (a + 1.0)).reciprocal()
    h = d
    for i in range(iters):
        for aa in (odd[..., i], even[..., i]):
            d = guard(torch.addcmul(one, aa, d)).reciprocal()
            c = guard(torch.addcdiv(one, aa, c))
            h = h * d * c
    return h


def betainc(a, b, x):
    """Regularized incomplete beta I_x(a, b); broadcasts over its arguments."""
    a, b, x = _float_tensors(a, b, x)
    swap = x >= (a + 1.0) / (a + b + 2.0)
    aa = torch.where(swap, b, a)
    bb = torch.where(swap, a, b)
    xx = torch.where(swap, 1.0 - x, x).clamp(0.0, 1.0)
    log_front = (aa * torch.log(xx) + bb * torch.log1p(-xx)
                 - (gammaln(aa) + gammaln(bb) - gammaln(aa + bb)))
    val = torch.exp(log_front) * _betacf(aa, bb, xx) / aa
    val = torch.where(swap, 1.0 - val, val)
    val = torch.where(x <= 0.0, 0.0, val)
    return torch.where(x >= 1.0, 1.0, val)


def gammaincinv(a, p):
    """Inverse of the regularized lower incomplete gamma P(a, x) in x.

    Broadcasts over ``a`` and ``p``.  Edge cases: p<=0 -> 0, p>=1 -> inf.
    The bracket widening reads a flag back to the host once per doubling
    (off the main path: the default limits call no chi^2 quantile).
    """
    a, p = _float_tensors(a, p)
    # Upper bracket: mean + k*std of Gamma(a,1) grows like a + k*sqrt(a);
    # double it for every element while any element needs it, as the
    # reference's while_loop does, so that the brackets agree.
    hi = a + 40.0 * torch.sqrt(a) + 40.0
    hi_cap = torch.finfo(a.dtype).max / 4.0
    val = gammainc(a, hi)
    while bool(torch.any((val < p) & (hi < hi_cap))):
        hi = hi * 2.0
        val = gammainc(a, hi)
    lo = torch.zeros_like(hi)
    lg = gammaln(a)
    # d/dx P(a, x) = x^(a-1) e^(-x) / Gamma(a)
    logpdf = lambda x: (a - 1.0) * torch.log(x.clamp_min(1e-300)) - x - lg
    x = _bisect(lambda x: gammainc(a, x), p, lo, hi, logpdf=logpdf)
    x = torch.where(p <= 0.0, 0.0, x)
    return torch.where(p >= 1.0, torch.inf, x)


def betaincinv(a, b, p):
    """Inverse of the regularized incomplete beta I_x(a, b) in x on [0, 1]."""
    a, b, p = _float_tensors(a, b, p)
    lo = torch.zeros_like(p)
    hi = torch.ones_like(p)
    # d/dx I_x(a, b) = x^(a-1) (1-x)^(b-1) / B(a, b)
    logbeta = gammaln(a) + gammaln(b) - gammaln(a + b)
    logpdf = lambda x: ((a - 1.0) * torch.log(x.clamp_min(1e-300))
                        + (b - 1.0) * torch.log((1.0 - x).clamp_min(1e-300))
                        - logbeta)
    x = _bisect(lambda x: betainc(a, b, x), p, lo, hi, logpdf=logpdf)
    x = torch.where(p <= 0.0, 0.0, x)
    return torch.where(p >= 1.0, 1.0, x)


def chi2_ppf(p, df):
    """chi^2 quantile; matches scipy.stats.chi2.ppf."""
    df, p = _float_tensors(df, p)
    return 2.0 * gammaincinv(df / 2.0, p)


def chi2_cdf(x, df):
    x, df = _float_tensors(x, df)
    return gammainc(df / 2.0, x / 2.0)


def f_ppf(p, dfn, dfd):
    """F-distribution quantile; matches scipy.stats.f.ppf.

    Uses the Beta relationship: X~F(d1,d2)  <=>  d1*X/(d1*X+d2) ~ Beta(d1/2, d2/2).
    """
    p, dfn, dfd = _float_tensors(p, dfn, dfd)
    y = betaincinv(dfn / 2.0, dfd / 2.0, p)
    # Guard y -> 1 (p -> 1): quantile diverges.
    out = dfd * y / (dfn * (1.0 - y))
    return torch.where(p >= 1.0, torch.inf, out)


def f_cdf(x, dfn, dfd):
    x, dfn, dfd = _float_tensors(x, dfn, dfd)
    y = dfn * x / (dfn * x + dfd)
    return betainc(dfn / 2.0, dfd / 2.0, y)
