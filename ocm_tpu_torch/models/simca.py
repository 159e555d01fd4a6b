"""SIMCA one-class models (port of ``ocm_tpu/models/simca.py``).

- ``fit_simca`` fits one model from ``(n, L)`` or a stack of C models from
  ``(C, n, L)`` in one batched solve, where the JAX package vmaps;
  ``solver='svd'`` is the strict sklearn-parity path, ``solver='rsvd'``
  the GEMM-only randomized fit.
- ``fit_simca_masked`` fits under a row mask ``w`` (..., n), batched over
  leading axes (class, fold): the masked eigendecomposition
  (``masked_pca_eig``, on the covariance or the sample Gram side) or the
  randomized fit, and limit engines on masked statistics.  It is what
  ``fit_classes`` runs for classes of unequal size (each padded with
  repeats of its first row) and what CV-SIMCA's folds are
  (``models.cv``).
- ``predict_classes`` scores a batch against all C models through the
  fused CUDA kernel (``ops.kernels.t2q_scores_multiclass``), one read of
  the spectra for every class, centering directly; f32 spectra, or bf16
  pre-centered residuals with their ``x_offset`` (the serving scorer's
  half-width storage).
- ``predict_classes_int8`` scores int8-quantized residuals through the
  exact int8 product (kernel K8, ``ops.linalg.t2_q_scores_multiclass_int8``).
- ``SIMCA`` is the sklearn-style estimator with the reference's quirks
  (``transform`` returns the last class only, 'dd' shares the last
  class's dofs, ``score`` returns specificity).
- ``simca_model_from_numpy``/``simca_model_to_numpy`` carry a model across
  from the JAX package in the dict layout its ``save_simca_model`` writes;
  ``save_simca_model``/``load_simca_model`` write and read that file
  (``utils.msgpack_io``), byte-equal to the JAX package's.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ocm_tpu_torch._device import as_tensor, resolve_device
from ocm_tpu_torch.ops.kernels import t2q_scores_multiclass
from ocm_tpu_torch.ops.linalg import (cov, deflated_thetas, eigh_desc_signed,
                                      full_f32_matmul, pca_fit, pca_topk_cov,
                                      pinv_psd, sign_columns,
                                      t2_q_scores_multiclass_int8)
from ocm_tpu_torch.ops.special import chi2_ppf
from ocm_tpu_torch.stats import limits as L
from ocm_tpu_torch.stats.metrics import conformity_metrics
from ocm_tpu_torch.utils import msgpack_io


class SIMCAModel(NamedTuple):
    """One fitted SIMCA model, or C of them stacked on a leading axis."""

    mean: torch.Tensor           # (..., L)
    components: torch.Tensor     # (..., k, L)
    invcovT: torch.Tensor        # (..., k, k)
    eigenvalues: torch.Tensor    # (..., r) full spectrum (svd) or top-s (rsvd)
    t2_res: L.LimitResult
    q_res: L.LimitResult
    d_limit: torch.Tensor        # (...)
    t2_train: torch.Tensor       # (..., n)
    q_train: torch.Tensor        # (..., n)
    n_samples: torch.Tensor      # (...)


def fit_simca(x_cls, n_components: int, decision_type: str = "alt",
              t2_method: str = "Fdist", q_method: str = "jm",
              t2_cl: float = 0.95, q_cl: float = 0.95, d_cl: float = 0.95,
              dtype=None, solver: str = "svd", oversample: int = 10,
              subspace_iters: int = 4, device=None, omega=None) -> SIMCAModel:
    """Fit SIMCA models on ``x_cls`` (n, L), or (C, n, L) for C classes of
    equal size at once.

    ``solver='svd'`` reproduces sklearn's full SVD; ``solver='rsvd'``
    computes only the top-(k + oversample) eigenpairs of the covariance
    by randomized subspace iteration (``ops.linalg.pca_topk_cov``, test
    matrix ``omega`` or its seeded default) with the residual moments
    recovered by exact deflation.  ``SIMCAModel.eigenvalues`` holds the
    full spectrum for 'svd' and the top-(k + oversample) one for 'rsvd'.
    """
    x = as_tensor(x_cls, device, dtype)
    if x.dim() not in (2, 3):
        raise ValueError(f"x_cls must be (n, L) or (C, n, L), got "
                         f"{tuple(x.shape)}")
    n, length = x.shape[-2:]
    if not 0 < n_components <= min(n, length):
        raise ValueError(
            f"n_components={n_components} must be in [1, min(n_samples,"
            f" length)={min(n, length)}]")
    if solver not in ("svd", "rsvd"):
        raise ValueError(f"unknown solver {solver!r}; expected 'svd' or"
                         " 'rsvd'")
    k = n_components
    with full_f32_matmul():
        if solver == "svd":
            fit = pca_fit(x)
            mean, eigenvalues = fit.mean, fit.eigenvalues
            t = fit.scores[..., :k]
            p = fit.components[..., :k, :]
            xc = x - mean[..., None, :]
            thetas = L.residual_thetas(eigenvalues, k, max_rank=min(n, length))
        else:
            s = min(k + oversample, length, n - 1)
            mean = x.mean(-2)
            xc = x - mean[..., None, :]
            c = (xc.mT @ xc) / (n - 1.0)
            eigenvalues, eigvecs = pca_topk_cov(c, s, iters=subspace_iters,
                                                omega=omega)
            p = eigvecs[..., :k].mT
            t = xc @ p.mT
            thetas = deflated_thetas(c, eigenvalues, eigvecs, k)
        invcovT = pinv_psd(cov(t))
        t2 = ((t @ invcovT) * t).sum(-1)
        q = ((xc * xc).sum(-1) - (t * t).sum(-1)).clamp_min(0.0)
    t2_res = L.t2_limit(t2, k, t2_method, t2_cl)
    q_res = L.q_limit(q, q_method, q_cl, thetas=thetas)
    d_limit = L.critical_distance(decision_type, t2_res, q_res,
                                  n_components=k, thetas=thetas, dcl=d_cl)
    return SIMCAModel(
        mean=mean, components=p, invcovT=invcovT, eigenvalues=eigenvalues,
        t2_res=t2_res, q_res=q_res, d_limit=d_limit, t2_train=t2, q_train=q,
        n_samples=torch.full(x.shape[:-2], n, dtype=torch.int64,
                             device=x.device))


def _on_model(models: SIMCAModel, x):
    """``x`` as a tensor on the models' device, in their dtype; a bf16
    tensor stays bf16 (the kernel reads it at half width)."""
    if isinstance(x, torch.Tensor) and x.dtype == torch.bfloat16:
        return x.to(models.mean.device)
    return torch.as_tensor(x, dtype=models.mean.dtype,
                           device=models.mean.device)


def simca_scores(model: SIMCAModel, x, x_offset=None):
    """T^2 and Q of ``x`` (N, L) against one model, or a (C,) stack of them.

    Runs through the fused kernel (plain twin on the CPU).  ``x_offset``
    (L,): ``x`` holds residuals ``x - x_offset``, and the offset folds into
    the means.  Returns t2, q shaped (N,) for one model and (C, N) for a
    stack.
    """
    x = _on_model(model, x).contiguous()
    mean = model.mean
    if x_offset is not None:
        mean = mean - torch.as_tensor(x_offset, dtype=mean.dtype,
                                      device=mean.device)
    stacked = [a.contiguous() for a in (mean, model.components,
                                        model.invcovT)]
    if model.mean.dim() == 1:
        t2, q = t2q_scores_multiclass(x, *(a[None] for a in stacked))
        return t2[0], q[0]
    return t2q_scores_multiclass(x, *stacked)


def simca_decide(model: SIMCAModel, x, decision_type: str = "alt",
                 x_offset=None):
    """Accept/reject + reduced distance; accept uses the reference's strict
    ``<``.  Returns (accept, dred, t2, q)."""
    t2, q = simca_scores(model, x, x_offset)
    dred = L.reduced_distance(decision_type, t2, q, model.t2_res, model.q_res)
    return dred < model.d_limit[..., None], dred, t2, q


def reduced_train_distances(model: SIMCAModel, decision_type: str):
    """T2red/Qred of the training data."""
    if decision_type == "dd":
        t2red = model.t2_res.dof[..., None] * model.t2_train / model.t2_res.scale[..., None]
        qred = model.q_res.dof[..., None] * model.q_train / model.q_res.scale[..., None]
    else:
        t2red = model.t2_train / model.t2_res.limit[..., None]
        qred = model.q_train / model.q_res.limit[..., None]
    return t2red, qred


def fit_classes(x, classes, class_labels, n_components: int, device=None,
                **kwargs) -> SIMCAModel:
    """Fit one model per class as a single batched solve.

    Equal class sizes stack into (C, n, L) for ``fit_simca``.  Unequal ones
    are padded to the largest class with repeats of each class's first row
    and fitted under their masks by ``fit_simca_masked`` (solver 'eigh' or
    'rsvd'; its side chosen by the padded shape), as the reference does.
    ``n_components`` must fit the smallest class.
    """
    x = as_tensor(x, device)
    classes = np.asarray(classes)
    rows = [np.flatnonzero(classes == c) for c in class_labels]
    counts = [r.size for r in rows]
    bad = [(c, cnt) for c, cnt in zip(class_labels, counts)
           if n_components > min(cnt, x.shape[1])]
    if bad:
        raise ValueError(
            f"n_components={n_components} exceeds the effective bound "
            f"min(count, L={x.shape[1]}) for class(es) "
            + ", ".join(f"{c!r} (count={cnt})" for c, cnt in bad))
    n_max = max(counts)
    idx = np.stack([np.concatenate([r, np.full(n_max - r.size, r[0])])
                    for r in rows])
    stacked = x[torch.as_tensor(idx, device=x.device)]
    if len(set(counts)) == 1:
        return fit_simca(stacked, n_components, **kwargs)
    masks = torch.as_tensor(np.arange(n_max)[None, :]
                            < np.asarray(counts)[:, None], device=x.device)
    return fit_simca_masked(stacked, masks, n_components, **kwargs)


def predict_classes(models: SIMCAModel, x, decision_type: str = "alt",
                    x_offset=None):
    """Score one batch (N, L) against C stacked models through the fused
    kernel: (C, N) accept matrix, plus dred, t2 and q, each (C, N).

    ``x`` goes to the models' device in their dtype, except a bf16 tensor,
    which the kernel reads at 2 bytes an element and widens to f32 as it
    stages it (means, loadings and statistics stay f32).  Store bf16 as
    pre-centered residuals ``x - x_offset`` against an f32 reference
    spectrum ``x_offset`` (L,), which folds into the class means.

    The reference's ``x_sumsq`` (a precomputed ``||x||^2``) is not ported:
    the kernel forms ``||x - m_c||^2`` in its single read of ``x`` and
    never expands Q, so the second read it spares
    (``ocm_tpu/ops/linalg.py:376-383``) and the expansion's cancellation
    (``ocm_tpu/models/simca.py:254-261``) do not arise here.
    """
    return simca_decide(models, x, decision_type, x_offset)


def predict_classes_int8(models: SIMCAModel, xq, x_scale, x_sumsq,
                         decision_type: str = "alt", x_offset=None):
    """``predict_classes`` over int8-quantized residuals.

    ``(xq, x_scale, x_sumsq)`` come from
    ``ops.linalg.quantize_rows_int8(x - x_offset)``: quantize the
    pre-centered residual, so that the error scales with the residual and
    not with the spectrum's common mode, and pass the same ``x_offset``.
    One exact int8 product (kernel K8 on the card) scores all C classes;
    statistics and limits are f32 or wider.  Returns (accept, dred, t2, q),
    each (C, N).
    """
    dev = models.mean.device
    xq, x_scale, x_sumsq = (torch.as_tensor(a, device=dev)
                            for a in (xq, x_scale, x_sumsq))
    if x_offset is not None:
        x_offset = torch.as_tensor(x_offset, dtype=models.mean.dtype,
                                   device=dev)
    t2, q, _ = t2_q_scores_multiclass_int8(
        xq.contiguous(), x_scale, x_sumsq, models.mean, models.components,
        models.invcovT, x_offset=x_offset)
    dred = L.reduced_distance(decision_type, t2, q, models.t2_res,
                              models.q_res)
    return dred < models.d_limit[:, None], dred, t2, q


# ---------------------------------------------------------------------------
# The masked fit: rows with w == 0 are excluded, batched over leading axes.
# ---------------------------------------------------------------------------

class MaskedPCA(NamedTuple):
    """A masked eigendecomposition, shared by a whole LV sweep.  Leaves may
    carry leading batch axes (class, fold)."""

    mean: torch.Tensor          # (..., L)
    eigvec: torch.Tensor        # (..., L, m) loadings as columns, sklearn
    #                             signs; m = L (cov side), min(N, L) (gram
    #                             side) or the subspace width s (rsvd)
    eigenvalues: torch.Tensor   # (..., m) descending, clipped at 0
    n: torch.Tensor             # (...) effective sample count sum(w)
    max_rank: torch.Tensor      # (...) min(n, L): valid eigenvalue slots


def masked_center(x, w):
    """(n, mean, centered rows zeroed where w == 0) of ``x`` (..., N, L)
    under weights ``w`` (..., N) in x's dtype; w broadcasts against x's
    batch shape."""
    n = w.sum(-1)
    mean = (x * w[..., None]).sum(-2) / n[..., None]
    return n, mean, (x - mean[..., None, :]) * w[..., None]


def masked_pca_eig(x, w, side: str = "auto") -> MaskedPCA:
    """Eigendecomposition of the masked covariance of ``x`` (..., N, L)
    (rows with ``w == 0`` excluded; ``w`` (..., N)).

    ``side='cov'`` decomposes the (L, L) covariance; ``'gram'`` the (N, N)
    sample Gram, whose loadings ``xc^T u_i / sqrt((n-1) lambda_i)`` are unit
    norm by construction; columns whose eigenvalue is below
    ``16 eps lambda_max`` (rounding noise: the centering null space,
    duplicate rows, constant channels) are zeroed, and min(N, L) columns
    are kept.  ``'auto'`` takes the smaller side.  Products run in full
    f32.
    """
    if side not in ("auto", "cov", "gram"):
        raise ValueError(f"unknown side {side!r}; expected"
                         " 'auto', 'cov' or 'gram'")
    big_n, length = x.shape[-2:]
    n, mean, xc = masked_center(x, w.to(x.dtype))
    max_rank = n.clamp_max(length).to(torch.int64)
    if side == "auto":
        side = "gram" if big_n < length else "cov"
    denom = (n - 1.0)[..., None, None]
    with full_f32_matmul():
        if side == "cov":
            eigenvalues, eigvec = eigh_desc_signed((xc.mT @ xc) / denom)
            return MaskedPCA(mean, eigvec, eigenvalues, n, max_rank)
        gvals, gvecs = torch.linalg.eigh((xc @ xc.mT) / denom)
        gvals = gvals.flip(-1).clamp_min(0.0)
        norm = torch.sqrt((gvals * (n - 1.0)[..., None])
                          .clamp_min(torch.finfo(x.dtype).tiny))
        v = (xc.mT @ gvecs.flip(-1)) / norm[..., None, :]
    cut = gvals[..., :1] * 16.0 * torch.finfo(x.dtype).eps
    v = sign_columns(torch.where((gvals > cut)[..., None, :], v, 0.0))
    k = min(big_n, length)
    return MaskedPCA(mean, v[..., :k], gvals[..., :k], n, max_rank)


def masked_topk_pca(x, w, n_vectors: int, iters: int, omega=None):
    """``(pca, c)``: the top-``n_vectors`` eigenpairs of the masked
    covariance ``c`` of ``x`` (..., N, L) under ``w`` (..., N), by
    randomized subspace iteration (``pca_topk_cov``, test matrix
    ``omega``).  The covariance product runs in full f32; ``max_rank`` is
    min(n, L)."""
    n, mean, xc = masked_center(x, w.to(x.dtype))
    with full_f32_matmul():
        c = (xc.mT @ xc) / (n - 1.0)[..., None, None]
    vals, vecs = pca_topk_cov(c, n_vectors, iters=iters, omega=omega)
    max_rank = n.clamp_max(x.shape[-1]).to(torch.int64)
    return MaskedPCA(mean, vecs, vals, n, max_rank), c


def masked_percentile(v, w, n, cl: float):
    """``np.percentile(v[w > 0], 100 cl)`` over the last axis, linearly
    interpolated: masked entries sort to +inf beyond the count ``n``
    (batch shape, broadcasting against ``v``'s)."""
    v_sorted = torch.where(w > 0, v, torch.inf).sort(-1).values
    last = v.shape[-1] - 1
    idx = cl * (n - 1.0)
    floor = torch.floor(idx)
    lo = floor.to(torch.int64).clamp(0, last).expand(v_sorted.shape[:-1])
    hi = (lo + 1).clamp(0, last)
    v_lo = v_sorted.gather(-1, lo[..., None])[..., 0]
    v_hi = torch.where(hi < n, v_sorted.gather(-1, hi[..., None])[..., 0],
                       v_lo)
    frac = idx - floor
    return v_lo * (1.0 - frac) + v_hi * frac


def masked_moments(v, w, n):
    """(mean, ddof-1 variance) over the last axis where ``w > 0``."""
    m = (v * w).sum(-1) / n
    var = (w * (v - m[..., None]) ** 2).sum(-1) / (n - 1.0)
    return m, var


def _masked_limit(v, w, n, method, cl):
    """'perc' or 'chi2pom' on masked statistics (Pomerantsev dof by
    half-to-even rounding of the masked ddof-1 moments)."""
    if method == "perc":
        lim = masked_percentile(v, w, n, cl)
        return L.LimitResult(lim, torch.ones_like(lim), torch.ones_like(lim))
    m, var = masked_moments(v, w, n)
    dof = torch.where(var > 0, torch.round(2 * m * m / var), 1.0)
    dof = dof.clamp_min(1.0)
    return L.LimitResult(m * chi2_ppf(cl, dof) / dof, dof, m)


def masked_t2_limit(t2, w, n, k, method: str, cl: float) -> L.LimitResult:
    """T^2 limit on masked statistics (``k``, ``n`` ints or per-batch
    tensors)."""
    if method in ("perc", "chi2pom"):
        return _masked_limit(t2, w, n, method, cl)
    return L.t2_limit(t2, k, method, cl, n_samples=n)


def masked_q_limit(q, w, n, method: str, cl: float, thetas) -> L.LimitResult:
    """Q limit on masked statistics."""
    if method in ("perc", "chi2pom"):
        return _masked_limit(q, w, n, method, cl)
    return L.q_limit(q, method, cl, thetas=thetas)


def _finish_masked_fit(x, w, n_components, decision_type, t2_method,
                       q_method, t2_cl, q_cl, d_cl, pca: MaskedPCA,
                       thetas) -> SIMCAModel:
    """Scores and masked limit engines from a decomposition: the shared
    tail of the eigh and rsvd masked fits."""
    w = w.to(x.dtype)
    n = pca.n
    xc = (x - pca.mean[..., None, :]) * w[..., None]
    p = pca.eigvec[..., :n_components].mT
    with full_f32_matmul():
        t = xc @ p.mT
        tm = (t * w[..., None]).sum(-2) / n[..., None]
        tc = (t - tm[..., None, :]) * w[..., None]
        invcovT = pinv_psd((tc.mT @ tc) / (n - 1.0)[..., None, None])
        t2 = ((t @ invcovT) * t).sum(-1)
        q = ((xc * xc).sum(-1) - (t * t).sum(-1)).clamp_min(0.0)
    t2_res = masked_t2_limit(t2, w, n, n_components, t2_method, t2_cl)
    q_res = masked_q_limit(q, w, n, q_method, q_cl, thetas)
    d_limit = L.critical_distance(decision_type, t2_res, q_res,
                                  n_components=n_components, thetas=thetas,
                                  dcl=d_cl)
    return SIMCAModel(
        mean=pca.mean, components=p, invcovT=invcovT,
        eigenvalues=pca.eigenvalues, t2_res=t2_res, q_res=q_res,
        d_limit=d_limit, t2_train=torch.where(w > 0, t2, 0.0),
        q_train=torch.where(w > 0, q, 0.0), n_samples=n.to(torch.int64))


def fit_simca_masked(x, w, n_components: int, decision_type: str = "alt",
                     t2_method: str = "Fdist", q_method: str = "jm",
                     t2_cl: float = 0.95, q_cl: float = 0.95,
                     d_cl: float = 0.95, max_rank=None,
                     solver: str = "eigh", oversample: int = 10,
                     subspace_iters: int = 4, device=None,
                     omega=None) -> SIMCAModel:
    """Masked SIMCA fit of ``x`` (..., N, L) under ``w`` (..., N): rows
    with ``w == 0`` are excluded.  Leading axes are fitted as one batch.

    ``solver='eigh'`` decomposes the masked covariance densely
    (``masked_pca_eig``, its side chosen by x's shape); ``'rsvd'`` takes
    the top-(k + oversample) eigenpairs by randomized subspace iteration
    (test matrix ``omega``, as for ``fit_simca``) with the residual moments
    from covariance deflation.  ``t2_train``/``q_train`` are 0 at masked
    rows; ``n_samples`` is each fit's count.
    """
    x = as_tensor(x, device)
    w = torch.as_tensor(w, device=x.device)
    if not 0 < n_components <= min(x.shape[-2:]):
        # the shape bound only; callers check each class's count
        raise ValueError(
            f"n_components={n_components} must be in [1, min(n_samples,"
            f" length)={min(x.shape[-2:])}]")
    length = x.shape[-1]
    if solver == "rsvd":
        pca, c = masked_topk_pca(x, w, min(n_components + oversample, length),
                                 subspace_iters, omega)
        if max_rank is not None:
            pca = pca._replace(
                max_rank=torch.as_tensor(max_rank, device=x.device))
        thetas = deflated_thetas(c, pca.eigenvalues, pca.eigvec, n_components)
    elif solver == "eigh":
        pca = masked_pca_eig(x, w)
        thetas = L.residual_thetas(
            pca.eigenvalues, n_components,
            max_rank=pca.max_rank if max_rank is None else max_rank)
    else:
        raise ValueError(f"unknown solver {solver!r}; expected 'eigh' or"
                         " 'rsvd'")
    return _finish_masked_fit(x, w, n_components, decision_type, t2_method,
                              q_method, t2_cl, q_cl, d_cl, pca, thetas)


# ---------------------------------------------------------------------------
# The sklearn-style estimator of the reference.
# ---------------------------------------------------------------------------

def stack_models(models) -> SIMCAModel:
    """Stack single-class models of one k along a new leading class axis,
    dropping the per-class-sized fields (training statistics, eigenvalue
    spectrum, count) that scoring does not read."""
    def leaf(name, values):
        if name in ("t2_train", "q_train", "eigenvalues", "n_samples"):
            return torch.zeros((len(values),), dtype=values[0].dtype,
                               device=values[0].device)
        if isinstance(values[0], L.LimitResult):
            return L.LimitResult(*(torch.stack(v) for v in zip(*values)))
        return torch.stack(values)

    return SIMCAModel(*(leaf(f, [getattr(m, f) for m in models])
                        for f in SIMCAModel._fields))


class SIMCA:
    """The reference's estimator API: fit one model per class, ``predict``
    an (N, n_classes) 0/1 matrix, metrics per class.  Its quirks stay:
    ``transform`` returns the last class's tuple only (Q1), 'dd' reduced
    distances use the last class's pooled dofs unless
    ``compat_dd_shared_state=False`` (Q7), ``score`` returns the
    specificity (Q10), and 'dd' forces both limits to 'chi2pom', saying so.

    ``device`` (a port option, kept by ``get_params``): where numpy input
    goes; CUDA unless given.  ``predict`` scores every class in one K1
    launch when they share ``n_components``, else one launch a class.
    """

    def __init__(self, n_components=2, model_class=None, type: str = "alt",
                 t2lim="Fdist", t2cl=0.95, qlim="jm", qcl=0.95, dcl=0.95,
                 maxPC=20, criteria="compl", verbose=True, dtype=None,
                 compat_dd_shared_state=True, solver="svd", device=None):
        self.solver = solver
        self.n_components = n_components
        self.model_class = model_class
        self.type = type
        self.t2lim = t2lim
        self.t2cl = t2cl
        self.qlim = qlim
        self.qcl = qcl
        self.dcl = dcl
        self.maxPC = maxPC
        self.criteria = criteria
        self.verbose = verbose
        self.dtype = dtype
        self.compat_dd_shared_state = compat_dd_shared_state
        self.device = device
        self.metrics = {}

    def get_params(self, deep=True):
        return {k: getattr(self, k) for k in (
            "n_components", "model_class", "type", "t2lim", "t2cl", "qlim",
            "qcl", "dcl", "maxPC", "criteria", "verbose", "dtype",
            "compat_dd_shared_state", "solver", "device")}

    def set_params(self, **params):
        for k, v in params.items():
            setattr(self, k, v)
        return self

    def fit(self, X, classes):
        if self.model_class is None:
            self.model_class = list(np.unique(classes))
        elif isinstance(self.model_class, (int, np.integer)):
            self.model_class = [self.model_class]

        ncomp = self.n_components
        if not isinstance(ncomp, list):
            ncomp = [ncomp]
        if len(ncomp) == 1:
            ncomp = ncomp * len(self.model_class)
        elif len(ncomp) != len(self.model_class):
            raise ValueError("n_components length must match number of classes")
        self._n_components_per_class = ncomp

        if self.type == "dd" and self.t2lim != "chi2pom":
            print("t2lim set as chi2pom")
            self.t2lim = "chi2pom"
        if self.type == "dd" and self.qlim != "chi2pom":
            print("qlim set as chi2pom")
            self.qlim = "chi2pom"

        X = as_tensor(X, self.device)
        classes = np.asarray(classes)
        self._model = {}
        for i, cls in enumerate(self.model_class):
            rows = np.flatnonzero(classes == cls)
            if rows.size == 0:
                raise ValueError(f"no samples for model class {cls!r}")
            max_k = min(rows.size, X.shape[1])
            if not 0 < ncomp[i] <= max_k:
                raise ValueError(
                    f"n_components={ncomp[i]} for class {cls!r} must be in "
                    f"[1, min(n_samples, n_features)] = [1, {max_k}]")
            self._model[cls] = fit_simca(
                X[torch.as_tensor(rows, device=X.device)], ncomp[i],
                self.type, self.t2lim, self.qlim, self.t2cl, self.qcl,
                self.dcl, dtype=self.dtype, solver=self.solver)
        self.n_features_in_ = X.shape[1]
        self.is_fitted_ = True
        return self

    def _check_fitted(self):
        if not getattr(self, "is_fitted_", False):
            raise RuntimeError(
                "This SIMCA instance is not fitted yet; call fit(X, classes) "
                "before predict/transform/score.")

    def _dd_limits(self, model: SIMCAModel):
        """Quirk Q7: 'dd' reduced distances use the LAST class's pooled
        dofs and scales, while each class keeps its own D_limit;
        ``compat_dd_shared_state=False`` uses each class's own."""
        if self.type == "dd" and self.compat_dd_shared_state:
            last = self._model[self.model_class[-1]]
            return model._replace(t2_res=last.t2_res, q_res=last.q_res)
        return model

    def transform(self, X):
        """Quirk Q1: (T2, T2red, Q, Qred) of the LAST class only, the one
        tuple the reference's loop over classes returns."""
        self._check_fitted()
        model = self._dd_limits(self._model[self.model_class[-1]])
        t2, q = simca_scores(model, X)
        if self.type == "dd":
            t2red = model.t2_res.dof * t2 / model.t2_res.scale
            qred = model.q_res.dof * q / model.q_res.scale
        else:
            t2red = t2 / model.t2_res.limit
            qred = q / model.q_res.limit
        return (t2, t2red, q, qred)

    def predict(self, X, y_true=None):
        self._check_fitted()
        models = [self._dd_limits(self._model[cls])
                  for cls in self.model_class]
        X = _on_model(models[0], X)
        if len(models) > 1 and len(set(self._n_components_per_class)) == 1:
            accept = predict_classes(stack_models(models), X, self.type)[0]
        else:
            accept = torch.stack([simca_decide(m, X, self.type)[0]
                                  for m in models])
        predictions = accept.T.cpu().numpy().astype(np.float64)

        for i, cls in enumerate(self.model_class):
            if y_true is not None:
                self.metrics[cls] = self._metrics_simca_conformity(
                    y_true, predictions[:, i], cls)
                if self.verbose:
                    mm = self.metrics[cls]
                    print(f"Sample class {cls} = {int(np.sum(np.asarray(y_true) == cls))}")
                    print(f"Confusion Matrix for class {cls}:\nTP: {mm['TP']}, "
                          f"TN: {mm['TN']}, FP: {mm['FP']}, FN: {mm['FN']}")
                    print(f"Class {cls} - Sensitivity: {mm['sensitivity']}, "
                          f"Specificity: {mm['specificity']:.4f}, "
                          f"Accuracy: {mm['accuracy']:.4f}, "
                          f"Efficiency: {mm['efficiency']:.4f}")
        return predictions

    def score(self, X, y):
        """Quirk Q10: returns the specificity only."""
        y_pred = self.predict(X, y_true=y)
        m = conformity_metrics(np.asarray(y), np.ravel(y_pred),
                               self.model_class[0], device="cpu")
        return float(m.specificity)

    def _metrics_simca_conformity(self, y_true, y_pred, class_index):
        """The conformity metrics as the reference's dict, on the host."""
        m = conformity_metrics(np.asarray(y_true), np.asarray(y_pred),
                               class_index, device="cpu")
        return {
            "sensitivity": float(m.sensitivity),
            "specificity": float(m.specificity),
            "accuracy": float(m.accuracy),
            "efficiency": float(m.efficiency),
            "TP": int(m.tp), "TN": int(m.tn), "FP": int(m.fp), "FN": int(m.fn),
        }


def simca_model_to_numpy(model: SIMCAModel) -> dict:
    """The model as a dict of numpy arrays, in the layout the JAX package's
    ``save_simca_model`` writes: field -> array, with ``t2_res``/``q_res``
    as ``{limit, dof, scale}`` sub-dicts."""
    tree = {}
    for f in model._fields:
        v = getattr(model, f)
        tree[f] = ({k: a.detach().cpu().numpy() for k, a in v._asdict().items()}
                   if isinstance(v, L.LimitResult) else v.detach().cpu().numpy())
    return tree


def simca_model_from_numpy(tree: dict, device=None) -> SIMCAModel:
    """Inverse of ``simca_model_to_numpy``: a model fitted by either package
    (numpy arrays, ``device='cuda'`` unless given) scores identically here."""
    device = resolve_device(device)
    kwargs = {}
    for f in SIMCAModel._fields:
        v = tree[f]
        kwargs[f] = (L.LimitResult(**{k: torch.as_tensor(np.asarray(a), device=device)
                                      for k, a in v.items()})
                     if isinstance(v, dict)
                     else torch.as_tensor(np.asarray(v), device=device))
    return SIMCAModel(**kwargs)


def save_simca_model(path: str, model: SIMCAModel) -> str:
    """Write a (possibly class-stacked) model to one msgpack file in the
    layout of the JAX package's ``save_simca_model``
    (``simca_model_to_numpy``), byte-equal to what flax writes for the
    same arrays.  Returns ``path``."""
    msgpack_io.save(path, simca_model_to_numpy(model))
    return path


def load_simca_model(path: str, device=None) -> SIMCAModel:
    """A model written by either package's ``save_simca_model``, on
    ``device`` (CUDA unless given)."""
    return simca_model_from_numpy(msgpack_io.load(path), device)
