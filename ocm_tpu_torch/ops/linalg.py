"""Core linear algebra for class models (port of the main-path subset of
``ocm_tpu/ops/linalg.py``, with the CV sweep's theta tables).

Every function takes optional leading batch (class) dimensions where the
JAX package vmaps.  Covariance-scale products run in full f32 inside
``full_f32_matmul`` (the counterpart of ``jax.default_matmul_precision(
"highest")``): reduced-precision (TF32) passes perturb the leading
eigenvalue enough to collapse the deflated residual moments, and with them
the Jackson-Mudholkar Q limits, to 0.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import numpy as np
import torch

from ocm_tpu_torch.ops.kernels import int8_gemm_s32


@contextlib.contextmanager
def full_f32_matmul():
    """Run f32 matrix products in full f32 (no TF32) and restore the
    previous setting on exit."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


class PCAFit(NamedTuple):
    """Full-rank PCA decomposition of one (or a batch of) data matrices.

    mean:        (..., L)    column means
    components:  (..., r, L) principal axes (rows), sklearn sign convention
    scores:      (..., N, r) projections of the centered training data
    eigenvalues: (..., r)    explained variances S^2/(N-1)
    """

    mean: torch.Tensor
    components: torch.Tensor
    scores: torch.Tensor
    eigenvalues: torch.Tensor


def _nonzero_sign(v):
    s = torch.sign(v)
    return torch.where(s == 0, 1.0, s)


def svd_flip_signs(u, vt):
    """sklearn's deterministic SVD sign convention: for each component, the
    entry of the corresponding row of Vt with the largest absolute value is
    made positive."""
    idx = vt.abs().argmax(-1, keepdim=True)
    signs = _nonzero_sign(torch.gather(vt, -1, idx))[..., 0]
    return u * signs[..., None, :], vt * signs[..., :, None]


def pca_fit(x, dtype=None) -> PCAFit:
    """Full-rank PCA via one SVD of the centered data (sklearn
    ``PCA(svd_solver='full')`` equivalent, signs included)."""
    if dtype is not None:
        x = x.to(dtype)
    mean = x.mean(-2)
    xc = x - mean[..., None, :]
    u, s, vt = torch.linalg.svd(xc, full_matrices=False)
    u, vt = svd_flip_signs(u, vt)
    eigenvalues = (s * s) / (x.shape[-2] - 1)
    return PCAFit(mean=mean, components=vt, scores=u * s[..., None, :],
                  eigenvalues=eigenvalues)


def sign_columns(v):
    """Each column's max-abs entry made positive (``svd_flip`` on loadings)."""
    idx = v.abs().argmax(-2, keepdim=True)
    return v * _nonzero_sign(torch.gather(v, -2, idx))


def eigh_desc_signed(c):
    """Eigendecomposition of a symmetric PSD matrix, descending, clipped at
    zero, with sklearn's sign convention."""
    eigval, eigvec = torch.linalg.eigh(c)
    return eigval.flip(-1).clamp_min(0.0), sign_columns(eigvec.flip(-1))


def pinv_psd(a, rcond: float = 1e-15):
    """Moore-Penrose pseudo-inverse of a symmetric PSD matrix via eigh."""
    w, v = torch.linalg.eigh(a)
    cutoff = rcond * w.abs().amax(-1, keepdim=True)
    w_inv = torch.where(w > cutoff, 1.0 / w, 0.0)
    return (v * w_inv[..., None, :]) @ v.mT


def cov(x, rowvar: bool = False):
    """np.cov(ddof=1) equivalent over the last two axes."""
    if rowvar:
        x = x.mT
    xc = x - x.mean(-2, keepdim=True)
    return (xc.mT @ xc) / (x.shape[-2] - 1)


def sym_orthonormalize(y, eps: float = 1e-7):
    """Loewdin (symmetric) orthonormalization of the columns of ``y``:
    GEMMs plus an eigendecomposition of the small (s, s) Gram matrix.
    Directions below ``eps * max`` are damped instead of amplified."""
    with full_f32_matmul():
        g = y.mT @ y
        w, v = torch.linalg.eigh(g)
        w = torch.maximum(w, eps * w.amax(-1, keepdim=True))
        return y @ ((v * torch.rsqrt(w)[..., None, :]) @ v.mT)


def default_omega(length: int, n_vectors: int, dtype, device, seed: int = 7):
    """The randomized subspace iteration's default (length, n_vectors) test
    matrix: standard normals from a ``torch.Generator`` seeded ``seed`` on
    ``device``.  (The JAX package draws from ``PRNGKey(seed)``, which torch
    cannot replay; pass its draw as ``omega`` to reproduce it.)"""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn((length, n_vectors), generator=gen, dtype=dtype,
                       device=device)


def pca_topk_cov(c, n_vectors: int, iters: int = 4, seed: int = 7,
                 omega=None):
    """Top-``n_vectors`` eigenpairs of a symmetric PSD matrix (or a batch),
    GEMM-only: randomized subspace iteration with Loewdin
    orthonormalization and Rayleigh-Ritz extraction.

    ``omega`` (L, n_vectors), or batched like ``c``, is the test matrix;
    by default ``default_omega`` on ``c``'s device, shared by every batch
    entry as the JAX package's vmap shares its key.  Within a degenerate
    eigenvalue cluster the basis is an arbitrary rotation, as for any
    dense solver.

    Returns ``(eigenvalues (..., s), eigvecs (..., L, s))`` in descending
    order with the sklearn sign convention applied.
    """
    if omega is None:
        omega = default_omega(c.shape[-1], n_vectors, c.dtype, c.device, seed)
    omega = omega.to(dtype=c.dtype, device=c.device)
    with full_f32_matmul():
        q = sym_orthonormalize(c @ omega)
        for _ in range(iters):
            q = sym_orthonormalize(c @ q)
        # double Loewdin at Rayleigh-Ritz only: the extraction basis must
        # be orthonormal even when the subspace Gram is ill-conditioned
        q = sym_orthonormalize(q)
        b = q.mT @ (c @ q)
        w, v = torch.linalg.eigh(0.5 * (b + b.mT))
        w = w.flip(-1).clamp_min(0.0)
        vecs = q @ v.flip(-1)
    return w, sign_columns(vecs)


def deflated_thetas(c, eigenvalues, eigvecs, n_components):
    """Residual eigenvalue moments theta_1..3 beyond ``n_components`` from
    the deflated covariance ``C - V_k diag(lam_k) V_k^T`` (deflate first,
    then take traces: the naive ``tr(C^m) - sum(lam_k^m)`` cancels in f32).
    """
    keep = torch.arange(eigenvalues.shape[-1],
                        device=eigenvalues.device) < n_components
    lam = torch.where(keep, eigenvalues.clamp_min(0.0), 0.0)
    with full_f32_matmul():
        v = eigvecs * torch.sqrt(lam)[..., None, :]
        c_res = c - v @ v.mT
        th1 = torch.diagonal(c_res, dim1=-2, dim2=-1).sum(-1).clamp_min(0.0)
        th2 = (c_res * c_res).sum((-2, -1)).clamp_min(0.0)
        th3 = (c_res * (c_res @ c_res)).sum((-2, -1)).clamp_min(0.0)
    return th1, th2, th3


class ThetaTables(NamedTuple):
    """Per-decomposition tables for the residual moments at any cut k.

    Built once from the fully deflated residual ``R = C - V diag(lam) V^T``
    (all s directions removed): ``C_res(k) = R + sum_{j >= k} lam_j v_j
    v_j^T``, so each trace power expands into R's invariants plus masked
    sums over per-direction tables, with no (L, L) product per k.  The
    leading eigenvalue stays inside R's elementwise deflation, so nothing
    cancels at its scale.  Each leaf may carry leading batch axes.
    """

    tr1: torch.Tensor    # (...) tr(R)
    tr2: torch.Tensor    # (...) ||R||_F^2 = tr(R^2)
    tr3: torch.Tensor    # (...) tr(R^3)
    lam: torch.Tensor    # (..., s) clamped eigenvalues
    ryy: torch.Tensor    # (..., s) ||R v_j||^2
    vry: torch.Tensor    # (..., s) v_j^T R v_j


def deflated_theta_tables(c, eigenvalues, eigvecs) -> ThetaTables:
    """``ThetaTables`` of a covariance (or a batch) and its top-s
    eigenpairs: three (L, L)-scale products, once per decomposition."""
    lam = eigenvalues.clamp_min(0.0)
    with full_f32_matmul():
        v = eigvecs * torch.sqrt(lam)[..., None, :]
        r = c - v @ v.mT
        y = r @ eigvecs                                     # (..., L, s)
        tr1 = torch.diagonal(r, dim1=-2, dim2=-1).sum(-1)
        tr2 = (r * r).sum((-2, -1))
        tr3 = (r * (r @ r)).sum((-2, -1))
        ryy = (y * y).sum(-2)
        vry = (eigvecs * y).sum(-2)
    return ThetaTables(tr1, tr2, tr3, lam, ryy, vry)


def thetas_from_tables(tab: ThetaTables, n_components):
    """Residual moments theta_1..3 beyond the cut ``n_components`` (an
    int, or a tensor that broadcasts against the tables' batch shape) from
    ``ThetaTables``: O(s) masked sums.

    With ``P = sum_{j >= k} lam_j v_j v_j^T`` and orthonormal V:
    theta_1 = tr(R) + sum lam; theta_2 = tr(R^2) + 2 sum lam vRv +
    sum lam^2; theta_3 = tr(R^3) + 3 sum lam ||Rv||^2 + 3 sum lam^2 vRv +
    sum lam^3.
    """
    idx = torch.arange(tab.lam.shape[-1], device=tab.lam.device)
    k = n_components[..., None] if isinstance(n_components, torch.Tensor) \
        else n_components
    lam = torch.where(idx >= k, tab.lam, 0.0)
    th1 = tab.tr1 + lam.sum(-1)
    th2 = tab.tr2 + 2.0 * (lam * tab.vry).sum(-1) + (lam * lam).sum(-1)
    th3 = (tab.tr3 + 3.0 * (lam * tab.ryy).sum(-1)
           + 3.0 * (lam * lam * tab.vry).sum(-1) + (lam ** 3).sum(-1))
    return th1.clamp_min(0.0), th2.clamp_min(0.0), th3.clamp_min(0.0)


def mahalanobis_sq(x, mean, cov_inv):
    """Row-wise squared Mahalanobis distance of ``x`` (..., N, k) to
    ``mean`` (..., k) under ``cov_inv`` (..., k, k)."""
    d = x - mean[..., None, :]
    return ((d @ cov_inv) * d).sum(-1)


def quantize_rows_int8(a):
    """Per-row symmetric int8 quantization: ``a ~= q * scale[:, None]``.

    Returns ``(q int8, scale f32, sumsq f32)``; ``sumsq`` is the exact
    squared norm of the quantized rows (the integer sum of squares times
    scale^2), computed once at storage time so that int8 scoring reads each
    row once.  A numpy array (the serving scorer's host prep of each chunk)
    gives numpy arrays, a tensor (the projection operand, on its device)
    tensors, by the same f32 arithmetic: ``amax / 127`` floored at 1e-30
    (an all-zero row gets a finite scale, not 0/0), round half to even,
    clip to +-127.  (The JAX package routes 2-D numpy input through its
    native library, bit-identical to this numpy form.)
    """
    if isinstance(a, np.ndarray):
        a = a.astype(np.float32, copy=False)
        scale = np.maximum(np.abs(a).max(-1) / np.float32(127.0),
                           np.float32(1e-30)).astype(np.float32)
        q = np.clip(np.round(a / scale[..., None]), -127, 127).astype(np.int8)
        sumsq = (np.sum(q.astype(np.int32) ** 2, axis=-1).astype(np.float32)
                 * scale * scale)
        return q, scale, sumsq
    a = a.to(torch.float32)
    scale = (a.abs().amax(-1) / 127.0).clamp_min(1e-30)
    q = torch.round(a / scale[..., None]).clamp(-127, 127).to(torch.int8)
    sumsq = (q.to(torch.int32).square().sum(-1, dtype=torch.int32)
             .to(torch.float32) * scale * scale)
    return q, scale, sumsq


def t2_q_scores_multiclass_int8(xq, x_scale, x_sumsq, means, components,
                                invcovs, x_offset=None):
    """T^2 and Q of int8-stored residuals against C models (port of
    ``ocm_tpu/ops/linalg.py:t2_q_scores_multiclass_int8``).

    ``xq`` (N, L) int8 with ``x_scale``/``x_sumsq`` (N,) f32 is the
    ``quantize_rows_int8`` of the pre-centered residuals ``x - x_offset``;
    the offset folds into the class means.  As in the reference, the
    stacked operand ``w = [P_1 .. P_C ; m_1 .. m_C]`` (M = C k + C rows)
    is quantized in two levels (int8 ``w_hi`` plus the re-quantized
    remainder ``w_lo``), and one exact s8 x s8 -> s32 product of ``xq``
    against ``[w_hi ; w_lo]`` (2M columns) reads the spectra once: kernel
    K8 (``ops.kernels.int8_gemm_s32``) on the card, its exact float64
    twin on the CPU.  Dequantization, T^2 and the expanded Q
    (``||x||^2 - 2 x.m + ||m||^2 - ||t||^2``, with ``x_sumsq`` shipped)
    run in the models' dtype, at least f32.  Returns t2 (C, N), q (C, N)
    and t (C, N, k).
    """
    acc = torch.promote_types(means.dtype, torch.float32)
    means, components = means.to(acc), components.to(acc)
    if x_offset is not None:
        means = means - x_offset.to(acc)[None, :]
    n_classes, k, length = components.shape
    w = torch.cat([components.reshape(n_classes * k, length), means])
    w_hi, s_hi, _ = quantize_rows_int8(w)
    w_lo, s_lo, _ = quantize_rows_int8(w - w_hi.to(acc) * s_hi[:, None])
    m = n_classes * k + n_classes
    g2 = int8_gemm_s32(xq, torch.cat([w_hi, w_lo]))       # (N, 2M) int32
    g2 = g2.to(acc) * x_scale[:, None].to(acc)
    g = g2[:, :m] * s_hi[None, :] + g2[:, m:] * s_lo[None, :]
    xp = g[:, :n_classes * k].reshape(-1, n_classes, k).permute(1, 0, 2)
    xm = g[:, n_classes * k:].T                           # (C, N)
    with full_f32_matmul():
        mp = torch.einsum("cl,ckl->ck", means, components)  # unquantized
        t = xp - mp[:, None, :]
        m2 = (means * means).sum(-1)
        q = (x_sumsq.to(acc)[None, :] - 2.0 * xm + m2[:, None]
             - (t * t).sum(-1)).clamp_min(0.0)
        t2 = torch.einsum("cnj,cjk,cnk->cn", t, invcovs.to(acc), t)
    return t2, q, t


def t2_q_scores(x, mean, components, invcovT):
    """Hotelling T^2 and Q residual for rows of ``x`` against one PCA model.

    ``||Xc - T P||^2 = ||Xc||^2 - ||T||^2`` for orthonormal loadings, so
    scoring needs one product and row reductions.  Returns ``(t2, q, t)``.
    """
    xc = x - mean[..., None, :]
    t = xc @ components.mT
    q = ((xc * xc).sum(-1) - (t * t).sum(-1)).clamp_min(0.0)
    t2 = ((t @ invcovT) * t).sum(-1)
    return t2, q, t
