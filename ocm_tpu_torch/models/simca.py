"""SIMCA one-class models (port of the main-path subset of
``ocm_tpu/models/simca.py``).

- ``fit_simca`` fits one model from ``(n, L)`` or a stack of C models from
  ``(C, n, L)`` in one batched solve, where the JAX package vmaps;
  ``solver='svd'`` is the strict sklearn-parity path, ``solver='rsvd'``
  the GEMM-only randomized fit.
- ``predict_classes`` scores a batch against all C models through the
  fused CUDA kernel (``ops.kernels.t2q_scores_multiclass``), one read of
  the spectra for every class, centering directly; f32 spectra, or bf16
  pre-centered residuals with their ``x_offset`` (the serving scorer's
  half-width storage).
- ``predict_classes_int8`` scores int8-quantized residuals through the
  exact int8 product (kernel K8, ``ops.linalg.t2_q_scores_multiclass_int8``).
- ``simca_model_from_numpy``/``simca_model_to_numpy`` carry a model across
  from the JAX package in the dict layout its ``save_simca_model`` writes.

What waits for later slices: the masked (unequal class size) fit, the
sklearn-style wrapper and msgpack persistence.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ocm_tpu_torch._device import as_tensor, resolve_device
from ocm_tpu_torch.ops.kernels import t2q_scores_multiclass
from ocm_tpu_torch.ops.linalg import (cov, deflated_thetas, full_f32_matmul,
                                      pca_fit, pca_topk_cov, pinv_psd,
                                      t2_q_scores_multiclass_int8)
from ocm_tpu_torch.stats import limits as L


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
    """Fit one model per class as a single batched solve (equal class sizes).

    Unequal class sizes need the masked fit, which is not ported yet.
    """
    x = as_tensor(x, device)
    classes = np.asarray(classes)
    counts = [int(np.sum(classes == c)) for c in class_labels]
    bad = [(c, cnt) for c, cnt in zip(class_labels, counts)
           if n_components > min(cnt, x.shape[1])]
    if bad:
        raise ValueError(
            f"n_components={n_components} exceeds the effective bound "
            f"min(count, L={x.shape[1]}) for class(es) "
            + ", ".join(f"{c!r} (count={cnt})" for c, cnt in bad))
    if len(set(counts)) != 1:
        raise NotImplementedError(
            "fit_classes with unequal class sizes needs the masked fit, "
            "which is not ported yet (ROADMAP.md queue 1 item 6)")
    stacked = torch.stack([x[torch.as_tensor(classes == c, device=x.device)]
                           for c in class_labels])
    return fit_simca(stacked, n_components, **kwargs)


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
