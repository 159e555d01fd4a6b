"""PLS-DA: partial least squares + linear discriminant analysis (port of
``ocm_tpu/models/plsda.py``).

Re-design of the reference's cheese PLS-DA baseline (``data_cheese.py:193-280``):
``PLSRegression(n_components)`` on integer labels, LDA on the PLS scores,
StratifiedKFold macro-F1 curves per component count, best-k refit, test
confusion matrix, and the discriminant-vector back-projection
``D = P_scaled @ W_lda.T`` (``data_cheese.py:305-328``).

- ``pls_fit`` is NIPALS PLS1 (the closed form of one deflation for a single
  target column, what ``PLSRegression.fit(X, labels)`` runs), a Python loop
  over components of small products on the input's device.  NIPALS is
  greedy: the k-component model is a prefix of the K-component one, so
  the component sweep of ``data_cheese.py:201-224`` needs one fit a fold;
  the per-k work is an LDA on the first k score columns.
- ``lda_fit``/``lda_predict`` implement Gaussian LDA with a shared
  within-class covariance (sklearn's decision rule).  ``dim_mask`` may
  carry leading batch axes: masked dimensions are identity-padded, so one
  batched call covers every component count (where the reference vmaps).

Products run in full f32 (no TF32): reduced-precision passes change the
later components.  Numpy input goes to ``device`` (CUDA unless given) in
its own dtype, float64 becoming float32 on CUDA (``_device.as_tensor``);
tensors stay where they are.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ocm_tpu_torch._device import as_tensor
from ocm_tpu_torch.ops.linalg import full_f32_matmul


class PLSModel(NamedTuple):
    """NIPALS PLS1 state (sklearn PLSRegression attribute names in the
    comments)."""

    x_mean: torch.Tensor    # (L,)
    x_std: torch.Tensor     # (L,)  all-ones when scale=False
    y_mean: torch.Tensor    # ()
    y_std: torch.Tensor     # ()
    weights: torch.Tensor   # (L, K)  x_weights_
    loadings: torch.Tensor  # (L, K)  x_loadings_
    y_loadings: torch.Tensor  # (K,)
    rotations: torch.Tensor  # (L, K)  x_rotations_ = W (P^T W)^-1
    scores: torch.Tensor    # (N, K)  x_scores_ of the training data


def pls_fit(x, y, n_components: int, scale: bool = True,
            device=None) -> PLSModel:
    """NIPALS PLS1 fit equal to ``PLSRegression(n_components).fit(X, y)``
    for a single target column (data_cheese.py:202-203)."""
    x = as_tensor(x, device)
    y = torch.as_tensor(y, dtype=x.dtype, device=x.device)
    x_mean, y_mean = x.mean(0), y.mean()
    if scale:
        # sklearn uses ddof=1 std and replaces 0 std with 1
        x_std = x.std(0, correction=1)
        x_std = torch.where(x_std == 0, 1.0, x_std)
        y_std = y.std(correction=1)
        y_std = torch.where(y_std == 0, 1.0, y_std)
    else:
        x_std = torch.ones_like(x_mean)
        y_std = torch.ones((), dtype=x.dtype, device=x.device)
    xd = (x - x_mean) / x_std
    yd = (y - y_mean) / y_std
    ws, ps, qs, ts = [], [], [], []
    with full_f32_matmul():
        for _ in range(n_components):
            w = xd.T @ yd                     # PLS1: one power iteration, exact
            w = w / torch.linalg.vector_norm(w)
            t = xd @ w
            tt = t @ t
            p = (xd.T @ t) / tt
            q = (yd @ t) / tt
            xd = xd - torch.outer(t, p)
            yd = yd - t * q
            ws.append(w), ps.append(p), qs.append(q), ts.append(t)
        weights, loadings = torch.stack(ws, 1), torch.stack(ps, 1)  # (L, K)
        # rotations R = W (P^T W)^{-1}: triangular system, prefix-consistent
        rotations = weights @ torch.linalg.inv(loadings.T @ weights)
    return PLSModel(x_mean, x_std, y_mean, y_std, weights, loadings,
                    torch.stack(qs), rotations, torch.stack(ts, 1))


def pls_transform(model: PLSModel, x, n_components: Optional[int] = None):
    """Scores of new data; first k columns == PLSRegression(k).transform."""
    x = torch.as_tensor(x, dtype=model.x_mean.dtype,
                        device=model.x_mean.device)
    with full_f32_matmul():
        t = ((x - model.x_mean) / model.x_std) @ model.rotations
    if n_components is not None:
        t = t[:, :n_components]
    return t


def pls_predict(model: PLSModel, x):
    """Regression prediction y_hat (PLSRegression.predict)."""
    t = pls_transform(model, x)
    with full_f32_matmul():
        return (t @ model.y_loadings) * model.y_std + model.y_mean


class LDAModel(NamedTuple):
    means: torch.Tensor      # (..., C, k) class means
    cov_inv: torch.Tensor    # (..., k, k) shared within-class covariance inverse
    log_priors: torch.Tensor  # (C,)
    coef: torch.Tensor       # (..., C, k)   Sigma^-1 mu_c
    intercept: torch.Tensor  # (..., C)


def lda_fit(scores, labels, n_classes: int, dim_mask=None) -> LDAModel:
    """Gaussian LDA with shared covariance (sklearn's decision rule).

    ``dim_mask`` (..., k) zeroes out trailing dimensions: masked dims get
    identity covariance and zero means, contributing nothing to the
    discriminants.  Leading axes of ``dim_mask`` are batch axes of the
    model (one LDA a mask, in one call).
    """
    s = torch.as_tensor(scores)
    labels = torch.as_tensor(labels, device=s.device)
    k = s.shape[-1]
    if dim_mask is None:
        dim_mask = torch.ones(k, dtype=s.dtype, device=s.device)
    s = s * dim_mask[..., None, :]                          # (..., N, k)
    onehot = (labels[:, None] == torch.arange(
        n_classes, device=s.device)[None, :]).to(s.dtype)   # (N, C)
    counts = onehot.sum(0)
    with full_f32_matmul():
        means = (onehot.T @ s) / counts[:, None]            # (..., C, k)
        centered = s - onehot @ means
        # sklearn: within-class covariance normalized by n - C
        cov = (centered.mT @ centered) / (s.shape[-2] - n_classes)
        cov = (cov * (dim_mask[..., :, None] * dim_mask[..., None, :])
               + torch.diag_embed(1.0 - dim_mask))
        cov_inv = torch.linalg.inv(cov)
        log_priors = torch.log(counts / s.shape[-2])
        coef = means @ cov_inv
    intercept = -0.5 * (coef * means).sum(-1) + log_priors
    return LDAModel(means, cov_inv, log_priors, coef, intercept)


def lda_predict(model: LDAModel, scores, dim_mask=None):
    """Class of each row of ``scores`` (..., N) under ``model``."""
    s = torch.as_tensor(scores)
    if dim_mask is not None:
        s = s * dim_mask[..., None, :]
    with full_f32_matmul():
        logits = s @ model.coef.mT + model.intercept[..., None, :]
    return logits.argmax(-1)


def f1_macro(y_true, y_pred, n_classes: int):
    """Macro-averaged F1 in float64, matching sklearn f1_score(
    average='macro') (data_cheese.py:209): classes absent from both y_true
    and y_pred still count as 0 toward the mean.  ``y_pred`` may carry
    leading batch axes."""
    y_pred = torch.as_tensor(y_pred)
    y_true = torch.as_tensor(y_true, device=y_pred.device)
    cls = torch.arange(n_classes, device=y_pred.device)
    pred, true = y_pred[..., None] == cls, (y_true[:, None] == cls)
    tp = (pred & true).sum(-2).double()
    fp = (pred & ~true).sum(-2).double()
    fn = (~pred & true).sum(-2).double()
    f1 = 2.0 * tp / torch.clamp(2.0 * tp + fp + fn, min=1.0)
    return f1.mean(-1)


# ---------------------------------------------------------------------------
# Component-sweep CV (data_cheese.py:193-224) as prefix evaluations.
# ---------------------------------------------------------------------------

def stratified_kfold_indices(labels, n_splits: int, shuffle: bool = True,
                             random_state: Optional[int] = 42):
    """Stratified fold assignment: per class, a seeded permutation dealt
    round-robin across folds.  Preserves class proportions per fold like
    sklearn StratifiedKFold; the exact index sets differ from sklearn's
    implementation (the reference's own deal, kept: fold composition is a
    protocol detail, not an output of the reference)."""
    labels = np.asarray(labels)
    assign = np.zeros(len(labels), dtype=int)
    rng = np.random.RandomState(random_state)
    for c in np.unique(labels):
        idx = np.flatnonzero(labels == c)
        if shuffle:
            idx = idx[rng.permutation(len(idx))]
        assign[idx] = np.arange(len(idx)) % n_splits
    return [(np.flatnonzero(assign != f), np.flatnonzero(assign == f))
            for f in range(n_splits)]


def plsda_f1_curves(x, y, max_components: int = 25, n_folds: int = 5,
                    random_state: int = 42, scale: bool = True, device=None):
    """Calibration + CV macro-F1 vs component count (data_cheese.py:193-224).

    One PLS(max_components) fit a fold (prefix property) and one batched
    LDA over the (K, K) component masks: K x folds sklearn fits collapse
    into n_folds + 1 fits.  Returns a dict with 'f1_cal' (K,), 'f1_cv'
    (K,) and 'best_n_components'.
    """
    x = as_tensor(x, device)
    y_np = np.asarray(y)
    n_classes = int(y_np.max()) + 1
    y_dev = torch.as_tensor(y_np, device=x.device)
    ks = torch.arange(1, max_components + 1, device=x.device)
    masks = (torch.arange(max_components, device=x.device)[None, :]
             < ks[:, None]).to(x.dtype)                         # (K, K)

    def curves_for(x_tr, y_tr, x_te, y_te):
        model = pls_fit(x_tr, y_tr.to(x.dtype), max_components, scale=scale)
        t_tr, t_te = pls_transform(model, x_tr), pls_transform(model, x_te)
        lda = lda_fit(t_tr, y_tr, n_classes, dim_mask=masks)
        pred = lda_predict(lda, t_te, dim_mask=masks)          # (K, N_te)
        return f1_macro(y_te, pred, n_classes).cpu().numpy()

    f1_cal = curves_for(x, y_dev, x, y_dev)
    folds = stratified_kfold_indices(y_np, n_folds, True, random_state)
    f1_folds = []
    for tr, te in folds:
        tr, te = (torch.as_tensor(i, device=x.device) for i in (tr, te))
        f1_folds.append(curves_for(x[tr], y_dev[tr], x[te], y_dev[te]))
    f1_cv = np.mean(f1_folds, axis=0)
    return {"f1_cal": f1_cal, "f1_cv": f1_cv,
            "best_n_components": int(np.argmax(f1_cv)) + 1}


class PLSDAResult(NamedTuple):
    pls: PLSModel
    lda: LDAModel
    n_components: int
    y_pred: np.ndarray
    confusion: np.ndarray
    f1_test: float


def plsda_fit_predict(x_train, y_train, x_test, y_test,
                      n_components: int, scale: bool = True,
                      device=None) -> PLSDAResult:
    """Final best-k PLS-DA fit + test evaluation (data_cheese.py:256-280)."""
    x_train = as_tensor(x_train, device)
    y_np = np.asarray(y_train)
    n_classes = int(max(y_np.max(), np.asarray(y_test).max())) + 1
    pls = pls_fit(x_train, y_np, n_components, scale=scale)
    t_tr, t_te = pls_transform(pls, x_train), pls_transform(pls, x_test)
    lda = lda_fit(t_tr, torch.as_tensor(y_np, device=x_train.device),
                  n_classes)
    pred = lda_predict(lda, t_te).cpu().numpy()
    conf = np.zeros((n_classes, n_classes), dtype=int)
    np.add.at(conf, (np.asarray(y_test, dtype=int), pred), 1)
    f1 = float(f1_macro(np.asarray(y_test), pred, n_classes))
    return PLSDAResult(pls, lda, n_components, pred, conf, f1)


def discriminant_vectors(pls: PLSModel, lda: LDAModel,
                         variance_scaled: bool = True):
    """Back-projected, normalized discriminant directions in spectral space
    (data_cheese.py:305-328): D = (P * sqrt(var(T))) @ W^T, columns
    L2-normalized, on the host in numpy.

    The reference uses sklearn's LDA ``coef_`` ((C-1, k) for C>2); the
    shared-covariance coef rows differ by a constant shift that the
    normalized projection removes, so W holds the differences of each
    class's row to the first class's."""
    p = pls.loadings.detach().cpu().numpy()
    w_full = lda.coef.detach().cpu().numpy()
    w = w_full[1:] - w_full[0] if w_full.shape[0] > 1 else w_full
    if variance_scaled:
        var = np.var(pls.scores.detach().cpu().numpy(), axis=0, ddof=1)
        p = p * np.sqrt(var)[None, :]
    d = p @ w.T
    norms = np.linalg.norm(d, axis=0, keepdims=True)
    return d / np.where(norms == 0, 1.0, norms)
