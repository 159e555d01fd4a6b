"""CV-SIMCA: cross-validated component selection as one batched solve
(port of ``ocm_tpu/models/cv.py``).

Fold membership is a mask over the rows of one matrix, so every (class x)
fold fit is a masked fit (``models.simca``) on leading batch axes: one
batched decomposition, one scores product a fold, shared by every LV.
The LV axis is a tensor axis too: the cumulative sums of ``t^2 / lambda``
and ``t^2`` over the component axis, read at each LV, give every LV's T^2
and Q at once (``cov(T) = diag(lambda)`` makes T^2 a sum over the retained
directions), and each limit engine (``f_ppf``, ``chi2_ppf``, ``jm_limit``)
runs once a sweep on tensors of shape (C, F, n_LV), not once a cell.

CV protocol of the reference (``ocm_tpu/models/cv.py``):
- ``ClasswiseKFoldWithExternalVal``: KFold over the target class only, in
  sklearn's order (``kfold_slices``, ``RandomState`` shuffles); each
  fold's test set is the held-out fold plus every other-class sample.
- spec is the mean over folds; sens is recomputed on the pooled
  predictions (each target sample from its own held-out fold, other-class
  samples from the LAST fold); eff = sqrt(sens * spec).
- ``cross_validate_simca_grid``: best by ``refit_metric`` with the first
  maximum winning, then a refit of the estimator on the full data.

Host-side fold construction is numpy; the solve runs on ``device`` (CUDA
unless given, or the input tensor's).  Covariance, Gram and scores
products run in full f32.
"""

from __future__ import annotations

import itertools
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ocm_tpu_torch._device import as_tensor
from ocm_tpu_torch.models.simca import (SIMCA, MaskedPCA, masked_pca_eig,
                                        masked_q_limit, masked_t2_limit,
                                        masked_topk_pca)
from ocm_tpu_torch.ops.linalg import (ThetaTables, deflated_theta_tables,
                                      full_f32_matmul, thetas_from_tables)
from ocm_tpu_torch.stats import limits as L


# ---------------------------------------------------------------------------
# Fold construction (host side, sklearn-compatible).
# ---------------------------------------------------------------------------

def kfold_slices(n: int, n_splits: int, shuffle: bool = False,
                 random_state: Optional[int] = None) -> list[np.ndarray]:
    """sklearn ``KFold`` fold indices: contiguous blocks, the first
    n % n_splits folds one element larger; seeded permutation if shuffled."""
    if n_splits < 2:
        raise ValueError("n_splits must be at least 2")
    if n < n_splits:
        raise ValueError(
            f"cannot split {n} samples into {n_splits} folds")
    idx = np.arange(n)
    if shuffle:
        rng = np.random.RandomState(random_state)
        rng.shuffle(idx)
    sizes = np.full(n_splits, n // n_splits, dtype=int)
    sizes[: n % n_splits] += 1
    out, start = [], 0
    for s in sizes:
        out.append(idx[start:start + s])
        start += s
    return out


class ClasswiseKFoldWithExternalVal:
    """K-fold over target-class samples with external validation: train =
    target class minus the held fold; test = held fold + ALL other-class
    samples.  Accepts ``cls_idx`` (explicit indices or a scalar label) or
    ``cls_label``."""

    def __init__(self, n_splits: int = 5, cls_idx=None, cls_label=None,
                 shuffle: bool = False, random_state: Optional[int] = None):
        self.n_splits = n_splits
        self.cls_idx = None if cls_idx is None else np.asarray(cls_idx)
        self.cls_label = cls_label
        self.shuffle = shuffle
        self.random_state = random_state

    def get_n_splits(self, X=None, y=None, groups=None):
        return self.n_splits

    def _resolve_cls_idx(self, X, y):
        cls_idx = self.cls_idx
        if cls_idx is None and self.cls_label is not None:
            if y is None:
                raise ValueError("cls_label requires y in split(X, y)")
            cls_idx = np.flatnonzero(np.asarray(y) == self.cls_label)
        if cls_idx is not None and np.ndim(cls_idx) == 0:
            if y is None:
                raise ValueError("scalar cls_idx needs y to resolve indices")
            cls_idx = np.flatnonzero(np.asarray(y) == int(cls_idx))
        if cls_idx is None or cls_idx.size == 0:
            raise ValueError("no target-class samples found")
        if cls_idx.size < self.n_splits:
            raise ValueError(
                f"{self.n_splits} splits > {cls_idx.size} target samples")
        return cls_idx

    def split(self, X, y=None, groups=None):
        cls_idx = self._resolve_cls_idx(X, y)
        others = np.setdiff1d(np.arange(np.shape(X)[0]), cls_idx)
        for fold_rel in kfold_slices(cls_idx.size, self.n_splits,
                                     self.shuffle, self.random_state):
            held = cls_idx[fold_rel]
            train_idx = np.setdiff1d(cls_idx, held)
            yield train_idx, np.concatenate([held, others])


def fold_masks(y, cls_label, n_splits: int, shuffle: bool = False,
               random_state: Optional[int] = None):
    """Fold membership as dense masks: (train (F, N), held (F, N)); the
    external test set of fold f is ``held[f] | (y != cls_label)``."""
    y = np.asarray(y)
    cls_idx = np.flatnonzero(y == cls_label)
    folds = kfold_slices(cls_idx.size, n_splits, shuffle, random_state)
    n = y.shape[0]
    train = np.zeros((n_splits, n), dtype=bool)
    held = np.zeros((n_splits, n), dtype=bool)
    for f, fold_rel in enumerate(folds):
        h = cls_idx[fold_rel]
        held[f, h] = True
        train[f, cls_idx] = True
        train[f, h] = False
    return train, held


# ---------------------------------------------------------------------------
# The batched (class x fold x LV) solve.
#
# Shapes: x (N, L) is shared; train/held masks (..., F, N) with leading
# class axes; other (..., N); lvs (n_LV,) LV counts.  Per-fold quantities
# are (..., F), per-cell ones (..., F, n_LV).
# ---------------------------------------------------------------------------

class LVSweep(NamedTuple):
    """Every (fold, LV) cell of a sweep: decisions over all N rows, fold
    metrics over each fold's external test set, and the limits."""

    accept: torch.Tensor      # (..., F, n_LV, N) bool
    sens: torch.Tensor        # (..., F, n_LV)
    spec: torch.Tensor        # (..., F, n_LV)
    t2_res: L.LimitResult     # (..., F, n_LV) each
    q_res: L.LimitResult
    d_limit: torch.Tensor     # (..., F, n_LV)


def lv_t2_q(eigenvalues, t, xc2, lvs):
    """T^2 and Q at every LV count of ``lvs`` (n_LV,) from scores ``t``
    (..., N, s) over the leading directions, the full spectrum
    ``eigenvalues`` (..., m) and the centered rows' squared norms ``xc2``
    (..., N).  Returns t2, q each (..., n_LV, N).

    T^2 = sum_{j<k} t_j^2 / lambda_j (``np.linalg.pinv``'s relative
    cutoff 1e-15 lambda_max) and Q = ||xc||^2 - sum_{j<k} t_j^2: both are
    cumulative sums over the component axis, read at each k."""
    s = t.shape[-1]
    lam = eigenvalues[..., :s]
    cutoff = 1e-15 * eigenvalues.amax(-1, keepdim=True)
    inv_lam = torch.where(lam > cutoff, 1.0 / lam.clamp_min(1e-300), 0.0)
    t_sq = t * t
    # a leading zero column: k = 0 reads no component
    t2_cum = F.pad((t_sq * inv_lam[..., None, :]).cumsum(-1), (1, 0))
    t_cum = F.pad(t_sq.cumsum(-1), (1, 0))
    k = lvs.clamp(max=s)
    t2 = t2_cum[..., k].mT
    q = (xc2[..., None, :] - t_cum[..., k].mT).clamp_min(0.0)
    return t2, q


def lv_limits(t2_train, q_train, w_train, n, lvs, thetas, decision_type,
              t2_method, q_method, t2_cl, q_cl, d_cl):
    """The masked limit engines and the critical distance of every cell,
    each engine called once: statistics (..., n_LV, N), ``w_train``
    (..., 1, N), ``n`` (..., 1), ``lvs`` (n_LV,), thetas (..., n_LV)."""
    t2_res = masked_t2_limit(t2_train, w_train, n, lvs, t2_method, t2_cl)
    q_res = masked_q_limit(q_train, w_train, n, q_method, q_cl, thetas)
    d_limit = L.critical_distance(decision_type, t2_res, q_res,
                                  n_components=lvs, thetas=thetas, dcl=d_cl)
    return t2_res, q_res, d_limit


def _lv_metrics(pca: MaskedPCA, thetas, t_all, xc2_all, w_train, held,
                other, lvs, decision_type: str, t2_method: str,
                q_method: str, t2_cl: float, q_cl: float,
                d_cl: float) -> LVSweep:
    """Decide and score every (fold, LV) cell from the shared
    decomposition: ``t_all`` (..., F, N, s) the scores of every row,
    ``w_train`` (..., F, N) 0/1 in the data's dtype."""
    t2_all, q_all = lv_t2_q(pca.eigenvalues, t_all, xc2_all, lvs)
    w = w_train[..., None, :]
    # with 0/1 weights, masking the statistics equals scoring masked rows
    t2_res, q_res, d_limit = lv_limits(
        t2_all * w, q_all * w, w, pca.n[..., None], lvs, thetas,
        decision_type, t2_method, q_method, t2_cl, q_cl, d_cl)
    dred = L.reduced_distance(decision_type, t2_all, q_all, t2_res, q_res)
    accept = dred < d_limit[..., None]

    # fold metrics over the external test set (held fold + other classes)
    held_, test = held[..., None, :], (held | other)[..., None, :]
    dt = t_all.dtype
    tp = (accept & held_ & test).sum(-1).to(dt)
    fn = (~accept & held_ & test).sum(-1).to(dt)
    fp = (accept & ~held_ & test).sum(-1).to(dt)
    tn = (~accept & ~held_ & test).sum(-1).to(dt)
    return LVSweep(accept, tp / (tp + fn) * 100.0, tn / (tn + fp) * 100.0,
                   t2_res, q_res, d_limit)


def fold_decomposition(x, w_train, solver: str, n_sub: int,
                       subspace_iters: int, side: str = "auto", omega=None):
    """Every fold's decomposition in one batch: masked mean, covariance
    (or Gram) and eigenpairs.  Returns ``(pca, thetas_of)``;
    ``thetas_of(lvs)`` gives the residual moments (..., n_LV) at each LV:
    full-spectrum sums on the eigh path, ``ThetaTables`` on the rsvd
    path (test matrix ``omega`` (L, n_sub), shared by every fold)."""
    if solver == "rsvd":
        pca, c = masked_topk_pca(x, w_train, n_sub, subspace_iters, omega)
        tab = deflated_theta_tables(c, pca.eigenvalues, pca.eigvec)
        # an LV axis after the fold axis
        tab = ThetaTables(*(a[..., None] for a in tab[:3]),
                          *(a[..., None, :] for a in tab[3:]))
        return pca, lambda lvs: thetas_from_tables(tab, lvs)
    pca = masked_pca_eig(x, w_train, side=side)
    return pca, lambda lvs: L.residual_thetas(
        pca.eigenvalues[..., None, :], lvs, max_rank=pca.max_rank[..., None])


def fold_lv_sweep(x, w_train, held, other, lvs, *, solver, n_sub,
                  subspace_iters, decision_type, t2_method, q_method,
                  t2_cl, q_cl, d_cl, side: str = "auto",
                  omega=None) -> LVSweep:
    """Every fold's full LV sweep: one batched decomposition, one scores
    product a fold (over the directions the largest LV reads), and every
    cell's limits and decisions.  ``w_train``/``held`` (..., F, N) bool,
    ``other`` (..., 1, N) bool."""
    pca, thetas_of = fold_decomposition(x, w_train, solver, n_sub,
                                        subspace_iters, side=side,
                                        omega=omega)
    xc = x - pca.mean[..., None, :]
    with full_f32_matmul():
        t_all = xc @ pca.eigvec[..., :int(lvs.max())]
    return _lv_metrics(pca, thetas_of(lvs), t_all, (xc * xc).sum(-1),
                       w_train.to(x.dtype), held, other, lvs, decision_type,
                       t2_method, q_method, t2_cl, q_cl, d_cl)


def pooled_aggregate(accept, spec, held, other, dtype):
    """Per-LV aggregates: spec = fold mean, sens on the pooled predictions
    (each target sample from its OWN held-out fold; other-class samples
    from the LAST fold, the reference's overwrite), eff = sqrt(sens spec).

    ``accept`` (..., F, n_LV, N) bool; ``spec`` (..., F, n_LV); ``held``
    (..., F, N); ``other`` (..., N)."""
    spec_mean = spec.mean(-2)
    own = torch.einsum("...fln,...fn->...ln", accept.to(dtype),
                       held.to(dtype))
    pooled = torch.where(other[..., None, :], accept[..., -1, :, :], own > 0)
    in_class = ~other[..., None, :]
    tp = (pooled & in_class).sum(-1).to(dtype)
    fn = (~pooled & in_class).sum(-1).to(dtype)
    sens = tp / (tp + fn) * 100.0
    return {"pred": pooled, "sens": sens, "spec": spec_mean,
            "eff": torch.sqrt(sens * spec_mean)}


def _sweep(x, y, class_labels, lv_values, n_splits, decision_type,
           t2_method, q_method, t2_cl, q_cl, d_cl, shuffle, random_state,
           solver, oversample, subspace_iters, side, device, omega):
    """Every class's (fold x LV) sweep in one batch: (LVSweep, pooled
    aggregates), each with a leading class axis."""
    if solver not in ("eigh", "rsvd"):
        raise ValueError(f"unknown solver {solver!r}; expected 'eigh' or"
                         " 'rsvd'")
    if decision_type == "dd":
        t2_method = q_method = "chi2pom"
    x = as_tensor(x, device)
    y = np.asarray(y)
    masks = [fold_masks(y, c, n_splits, shuffle, random_state)
             for c in class_labels]
    dev = x.device
    train = torch.as_tensor(np.stack([m[0] for m in masks]), device=dev)
    held = torch.as_tensor(np.stack([m[1] for m in masks]), device=dev)
    other = torch.as_tensor(np.stack([y != c for c in class_labels]),
                            device=dev)
    lvs = torch.as_tensor(list(lv_values), dtype=torch.int64, device=dev)
    n_sub = min(int(max(lv_values)) + oversample, x.shape[-1])
    sweep = fold_lv_sweep(x, train, held, other[:, None, :], lvs,
                          solver=solver, n_sub=n_sub,
                          subspace_iters=subspace_iters,
                          decision_type=decision_type, t2_method=t2_method,
                          q_method=q_method, t2_cl=t2_cl, q_cl=q_cl,
                          d_cl=d_cl, side=side, omega=omega)
    return sweep, pooled_aggregate(sweep.accept, sweep.spec, held, other,
                                   x.dtype)


def _to_numpy(out: dict) -> dict:
    return {k: v.cpu().numpy() for k, v in out.items()}


def cv_simca_sweep(x, y, cls_label, lv_values: Sequence[int],
                   n_splits: int = 5, decision_type: str = "alt",
                   t2_method: str = "Fdist", q_method: str = "jm",
                   t2_cl: float = 0.95, q_cl: float = 0.95,
                   d_cl: float = 0.95, shuffle: bool = False,
                   random_state: Optional[int] = None,
                   convert: bool = True, solver: str = "eigh",
                   oversample: int = 10, subspace_iters: int = 4,
                   side: str = "auto", device=None, omega=None):
    """All (fold x LV) fits of one target class in one batched solve.

    Returns ``spec`` (n_LV,) fold mean, ``sens`` (n_LV,) pooled, ``eff``,
    the pooled predictions ``pred`` (n_LV, N) and the per-fold
    ``fold_sens``/``fold_spec`` (F, n_LV): numpy, or tensors on the
    device with ``convert=False``.

    ``solver='eigh'`` decomposes each fold's masked covariance densely
    (``side`` 'cov', 'gram' or 'auto'); ``'rsvd'`` keeps the top-(max LV +
    oversample) eigenpairs by randomized subspace iteration (test matrix
    ``omega`` (L, s), by default the seeded ``ops.linalg.default_omega``)
    with per-LV residual moments from covariance deflation.
    """
    sweep, pooled = _sweep(x, y, [cls_label], lv_values, n_splits,
                           decision_type, t2_method, q_method, t2_cl, q_cl,
                           d_cl, shuffle, random_state, solver, oversample,
                           subspace_iters, side, device, omega)
    out = {**{k: v[0] for k, v in pooled.items()},
           "fold_sens": sweep.sens[0], "fold_spec": sweep.spec[0]}
    return _to_numpy(out) if convert else out


def cv_simca_sweep_multiclass(x, y, class_labels, lv_values: Sequence[int],
                              n_splits: int = 5, decision_type: str = "alt",
                              t2_method: str = "Fdist", q_method: str = "jm",
                              t2_cl: float = 0.95, q_cl: float = 0.95,
                              d_cl: float = 0.95, shuffle: bool = False,
                              random_state: Optional[int] = None,
                              solver: str = "eigh", oversample: int = 10,
                              subspace_iters: int = 4, side: str = "auto",
                              device=None, omega=None) -> dict:
    """Every class's full (fold x LV) sweep in one batched solve (classes
    a batch axis before the folds): ``sens``/``spec``/``eff`` (C, n_LV) and
    ``pred`` (C, n_LV, N), numpy; row c equals ``cv_simca_sweep`` of class
    ``class_labels[c]``."""
    _, pooled = _sweep(x, y, list(class_labels), lv_values, n_splits,
                       decision_type, t2_method, q_method, t2_cl, q_cl, d_cl,
                       shuffle, random_state, solver, oversample,
                       subspace_iters, side, device, omega)
    return _to_numpy(pooled)


# ---------------------------------------------------------------------------
# Grid search with the reference's API shape.
# ---------------------------------------------------------------------------

def parameter_grid(param_grid: dict):
    """sklearn ``ParameterGrid`` order: keys sorted, itertools product with
    the LAST key varying fastest."""
    if not param_grid:
        yield {}
        return
    keys = sorted(param_grid)
    for values in itertools.product(*(param_grid[k] for k in keys)):
        yield dict(zip(keys, values))


def cross_validate_simca_grid(estimator: SIMCA, X, y, cv,
                              LV_min: int = 2, LV_max: int = 10,
                              param_grid: Optional[dict] = None,
                              refit_metric: str = "eff",
                              class_index=None, print_summary: bool = True,
                              store_predictions: bool = False):
    """Grid x LV sweep x classwise CV, one batched sweep a grid combo.

    ``estimator`` is a ``models.simca.SIMCA`` (its ``device`` carries into
    the sweeps and the refit); ``cv`` a ``ClasswiseKFoldWithExternalVal``
    (its n_splits, shuffle and seed are used).  A grid over
    ``n_components`` replaces the LV sweep.  The estimator's solver 'rsvd'
    selects the randomized sweep, anything else the dense masked eigh.
    Returns results / best_params / best_LV / best_score / best_estimator
    (refit on the full data).
    """
    if param_grid is None:
        param_grid = {}
    if refit_metric not in ("eff", "spec", "sens"):
        raise ValueError(f"unknown refit_metric {refit_metric!r}")

    y = np.asarray(y)
    X = as_tensor(X, estimator.device)
    grid_includes_ncomp = any(k.endswith("n_components") for k in param_grid)
    cls_label = class_index
    if cls_label is None:
        mc = estimator.model_class
        cls_label = (mc[0] if isinstance(mc, list) else mc)
        if cls_label is None:
            cls_label = 1  # the reference's getattr(..., 'model_class', 1)

    results = []
    by_combo = []
    for combo in parameter_grid(param_grid):
        params = {**estimator.get_params(), **combo}
        lv_values = ([int(params["n_components"])] if grid_includes_ncomp
                     else list(range(LV_min, LV_max + 1)))
        sweep = cv_simca_sweep(
            X, y, cls_label, lv_values, n_splits=cv.get_n_splits(X, y),
            decision_type=params["type"], t2_method=params["t2lim"],
            q_method=params["qlim"], t2_cl=params["t2cl"],
            q_cl=params["qcl"], d_cl=params["dcl"],
            shuffle=getattr(cv, "shuffle", False),
            random_state=getattr(cv, "random_state", None),
            solver="rsvd" if params.get("solver") == "rsvd" else "eigh")
        for j, lv in enumerate(lv_values):
            results.append({"params": dict(combo), "LV": lv,
                            "spec": float(sweep["spec"][j]),
                            "sens": float(sweep["sens"][j]),
                            "eff": float(sweep["eff"][j])})
            if store_predictions:
                by_combo.append({"params": dict(combo), "LV": lv,
                                 "prediction": sweep["pred"][j].astype(float)})

    best_idx = int(np.argmax([r[refit_metric] for r in results]))
    best = results[best_idx]

    if print_summary:
        for r in results:
            print(f"  LV={r['LV']:>2} | SPEC={r['spec']:.4f} | "
                  f"SENS={r['sens']:.4f} | EFF={r['eff']:.4f}")
        print(f"[best @ {refit_metric}] LV={best['LV']} | "
              f"score={best[refit_metric]:.4f} | params={best['params']}")

    best_estimator = SIMCA(**estimator.get_params())
    best_estimator.set_params(**best["params"])
    if not grid_includes_ncomp:
        best_estimator.set_params(n_components=best["LV"])
    best_estimator.set_params(model_class=cls_label)
    best_estimator.fit(X, y)

    out = {"results": results, "best_params": dict(best["params"]),
           "best_LV": best["LV"], "best_score": best[refit_metric],
           "best_estimator": best_estimator}
    if store_predictions:
        out["by_combo"] = by_combo
    return out
