"""Conformity and classification metrics (port of ``ocm_tpu/stats/metrics.py``).

- one-class conformity metrics of a SIMCA or VAE screen, x100;
- binary conform/unconform metrics with per-class false acceptance;
- the (2, C) confusion matrix with either predicted-row order (quirk Q8);
- ROC-AUC by the rank statistic, ties averaged (= sklearn's).

Inputs are tensors or arrays; arrays go to ``device`` (CUDA unless given),
tensors stay where they are.  Counts are int64, ratios float64.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ocm_tpu_torch._device import as_tensor


class ConformityMetrics(NamedTuple):
    sensitivity: torch.Tensor
    specificity: torch.Tensor
    accuracy: torch.Tensor
    efficiency: torch.Tensor
    tp: torch.Tensor
    tn: torch.Tensor
    fp: torch.Tensor
    fn: torch.Tensor


def conformity_metrics(y_true, y_pred, class_index,
                       device=None) -> ConformityMetrics:
    """One-class conformity metrics, x100.  ``y_pred`` is 1 = accepted as
    in-class, 0 = rejected; in-class truth is ``y_true == class_index``."""
    pred = as_tensor(y_pred, device)
    true_class = as_tensor(y_true, pred.device) == class_index
    tp = ((pred == 1) & true_class).sum()
    tn = ((pred == 0) & ~true_class).sum()
    fp = ((pred == 1) & ~true_class).sum()
    fn = ((pred == 0) & true_class).sum()
    tp_, tn_, fp_, fn_ = (v.double() for v in (tp, tn, fp, fn))
    sens = tp_ / (tp_ + fn_) * 100.0
    spec = tn_ / (tn_ + fp_) * 100.0
    acc = (tp_ + tn_) / (tp_ + tn_ + fp_ + fn_) * 100.0
    return ConformityMetrics(sens, spec, acc, torch.sqrt(sens * spec),
                             tp, tn, fp, fn)


class BinaryMetrics(NamedTuple):
    accuracy: torch.Tensor
    precision: torch.Tensor
    recall: torch.Tensor
    f1: torch.Tensor
    fa_rates: torch.Tensor       # false-acceptance rate per anomaly class
    mean_false_acceptance: torch.Tensor


def confusion_matrix_2xc(pred_labels, labels_true, n_true_classes: int,
                         pred_row_order=(0, 1), device=None):
    """(2, C) confusion matrix: row i counts predictions equal to
    ``pred_row_order[i]``, column c the true class c.  The reference's SIMCA
    scripts order the rows [1, 0], its VAE scripts [0, 1] (quirk Q8)."""
    pred = as_tensor(pred_labels, device)
    labels = as_tensor(labels_true, pred.device)
    return torch.stack([
        torch.stack([((pred == p) & (labels == c)).sum()
                     for c in range(n_true_classes)])
        for p in pred_row_order])


def vae_binary_metrics(pred_labels, labels_true, n_true_classes: int,
                       device=None) -> BinaryMetrics:
    """Binary conform (0) / unconform (1) metrics against multi-class truth
    with class 0 the target: a (2, n_true) confusion matrix with predicted
    rows [0, 1], per-class false acceptance normalized over each anomaly
    column, and the reference's 1e-12 denominators."""
    conf = confusion_matrix_2xc(pred_labels, labels_true, n_true_classes,
                                (0, 1), device).double()
    tp, fn = conf[0, 0], conf[1, 0]
    fp, tn = conf[0, 1:].sum(), conf[1, 1:].sum()
    accuracy = (tp + tn) / (tp + tn + fp + fn + 1e-12)
    precision = tp / (tp + fp + 1e-12)
    recall = tp / (tp + fn + 1e-12)
    f1 = 2.0 * precision * recall / (precision + recall + 1e-12)
    fa_rates = conf[0, 1:] / (conf[:, 1:].sum(0) + 1e-12)
    return BinaryMetrics(accuracy, precision, recall, f1, fa_rates,
                         fa_rates.mean())


def roc_auc(y_true, score, device=None):
    """ROC-AUC through the Mann-Whitney U statistic, ties given their
    average rank; equals ``sklearn.metrics.roc_auc_score``."""
    score = as_tensor(score, device)
    if not score.dtype.is_floating_point:
        score = score.double()
    y_true = as_tensor(y_true, score.device)
    order = torch.argsort(score)
    s_sorted = score[order]
    first = torch.searchsorted(s_sorted, s_sorted, side="left") + 1
    last = torch.searchsorted(s_sorted, s_sorted, side="right")
    ranks = torch.empty_like(score).scatter_(
        0, order, 0.5 * (first + last).to(score.dtype))
    pos = y_true == 1
    n_pos = pos.sum().to(score.dtype)
    n_neg = score.shape[0] - n_pos
    u = torch.where(pos, ranks, 0.0).sum() - n_pos * (n_pos + 1) / 2.0
    return u / (n_pos * n_neg)
