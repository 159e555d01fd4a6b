"""The port's screen metrics (``ocm_tpu_torch.stats.metrics``) against
``ocm_tpu.stats.metrics`` on seeded labels and scores (counts exact,
ratios to 1e-12), on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest

from ocm_tpu.stats import metrics as JM
from ocm_tpu_torch.stats import metrics as TM


def _labels(seed, n=200, n_classes=4):
    rng = np.random.default_rng(seed)
    return rng.integers(0, n_classes, n), rng.integers(0, 2, n)


def _close(got, ref, what):
    np.testing.assert_allclose(np.asarray(got.cpu()), np.asarray(ref),
                               rtol=1e-12, atol=1e-12, err_msg=what)


@pytest.mark.parametrize("class_index", [0, 2])
def test_conformity_metrics_match_jax(class_index):
    y_true, y_pred = _labels(0)
    ref = JM.conformity_metrics(jnp.asarray(y_true), jnp.asarray(y_pred),
                                class_index)
    got = TM.conformity_metrics(y_true, y_pred, class_index, device="cpu")
    for name in JM.ConformityMetrics._fields:
        _close(getattr(got, name), getattr(ref, name), name)


def test_vae_binary_metrics_match_jax():
    y_true, y_pred = _labels(1)
    ref = JM.vae_binary_metrics(jnp.asarray(y_pred), jnp.asarray(y_true), 4)
    got = TM.vae_binary_metrics(y_pred, y_true, 4, device="cpu")
    for name in JM.BinaryMetrics._fields:
        _close(getattr(got, name), getattr(ref, name), name)


@pytest.mark.parametrize("order", [(0, 1), (1, 0)])
def test_confusion_matrix_2xc_matches_jax(order):
    y_true, y_pred = _labels(2)
    ref = JM.confusion_matrix_2xc(jnp.asarray(y_pred), jnp.asarray(y_true),
                                  4, order)
    got = TM.confusion_matrix_2xc(y_pred, y_true, 4, order, device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
def test_roc_auc_matches_jax(ties):
    rng = np.random.default_rng(3)
    y = rng.integers(0, 2, 150)
    score = rng.normal(size=150) + 0.8 * y
    if ties:
        score = np.round(score, 1)
    ref = JM.roc_auc(jnp.asarray(y), jnp.asarray(score))
    _close(TM.roc_auc(y, score, device="cpu"), ref, "auc")
