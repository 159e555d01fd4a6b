"""The port's PLS-DA (``ocm_tpu_torch.models.plsda``) against
``ocm_tpu.models.plsda`` and sklearn, on the CPU in float64.

- PLS weights, loadings, rotations, scores, y loadings and transforms and
  the LDA's means, coefficients and intercepts within 1e-8 relative of the
  JAX package's;
- predictions, ``f1_cal``, ``f1_cv``, the best k and the confusion matrix
  equal (the F1 values to 1e-12: the same counts, summed in another order);
- sklearn parity as ``tests/test_plsda.py`` pins it; the prefix property;
  the batched (K, k)-mask LDA equal to one LDA a component count.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocm_tpu.models import plsda as JP
from ocm_tpu_torch.models import plsda as TP
from ocm_tpu_torch.utils.synthetic import cheese_like

sklearn_cd = pytest.importorskip("sklearn.cross_decomposition")
from sklearn.discriminant_analysis import LinearDiscriminantAnalysis  # noqa: E402
from sklearn.metrics import f1_score  # noqa: E402


@pytest.fixture(scope="module")
def xy():
    rng = np.random.default_rng(17)
    n, length = 150, 40
    t = np.linspace(0, 1, length)
    xs, ys = [], []
    for c in range(3):
        base = np.sin(2 * np.pi * (2 + c) * t) + 0.4 * c
        amp = rng.normal(1, 0.1, (n // 3, 1))
        xs.append(amp * base + rng.normal(0, 0.05, (n // 3, length)))
        ys.append(np.full(n // 3, c))
    x, y = np.concatenate(xs), np.concatenate(ys)
    perm = rng.permutation(n)
    return x[perm], y[perm]


@pytest.fixture(scope="module")
def cheese():
    return cheese_like(seed=5, n_per_class=40, length=60)


def _close(got, ref, rtol=1e-8, what=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, what
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=rtol * max(np.abs(ref).max(), 1e-300),
                               err_msg=what)


@pytest.mark.parametrize("k,scale", [(1, True), (5, True), (12, True),
                                     (6, False)])
def test_pls_fit_matches_jax(xy, k, scale):
    x, y = xy
    ours = TP.pls_fit(x, y, k, scale=scale, device="cpu")
    ref = JP.pls_fit(jnp.asarray(x), jnp.asarray(y, jnp.float64), k,
                     scale=scale)
    for field in TP.PLSModel._fields:
        _close(getattr(ours, field), getattr(ref, field), what=field)
    x_new = x + np.random.default_rng(1).normal(0, 0.01, x.shape)
    _close(TP.pls_transform(ours, x_new), JP.pls_transform(ref, x_new))
    _close(TP.pls_transform(ours, x_new, 2), JP.pls_transform(ref, x_new, 2))
    _close(TP.pls_predict(ours, x_new), JP.pls_predict(ref, x_new))


@pytest.mark.parametrize("k", [1, 3, 8])
def test_pls_matches_sklearn(xy, k):
    x, y = xy
    skl = sklearn_cd.PLSRegression(n_components=k).fit(x, y.astype(float))
    ours = TP.pls_fit(x, y, k, device="cpu")
    t_our = ours.scores.numpy()
    signs = np.sign(np.sum(skl.x_scores_ * t_our, axis=0))
    np.testing.assert_allclose(t_our * signs, skl.x_scores_, atol=1e-8)
    np.testing.assert_allclose(ours.loadings.numpy() * signs,
                               skl.x_loadings_, atol=1e-8)
    x_new = x + np.random.default_rng(1).normal(0, 0.01, x.shape)
    np.testing.assert_allclose(TP.pls_transform(ours, x_new).numpy() * signs,
                               skl.transform(x_new), atol=1e-8)
    np.testing.assert_allclose(TP.pls_predict(ours, x_new).numpy(),
                               skl.predict(x_new).ravel(), atol=1e-8)


def test_prefix_property(xy):
    x, y = xy
    big = TP.pls_fit(x, y, 8, device="cpu")
    small = TP.pls_fit(x, y, 3, device="cpu")
    np.testing.assert_allclose(big.scores[:, :3].numpy(),
                               small.scores.numpy(), atol=1e-9)
    np.testing.assert_allclose(TP.pls_transform(big, x, 3).numpy(),
                               TP.pls_transform(small, x).numpy(), atol=1e-9)


def test_lda_matches_jax_and_sklearn(xy):
    x, y = xy
    t = TP.pls_fit(x, y, 5, device="cpu").scores
    ours = TP.lda_fit(t, torch.as_tensor(y), 3)
    ref = JP.lda_fit(jnp.asarray(t.numpy()), jnp.asarray(y), 3)
    for field in TP.LDAModel._fields:
        _close(getattr(ours, field), getattr(ref, field), what=field)
    pred = TP.lda_predict(ours, t).numpy()
    np.testing.assert_array_equal(pred, np.asarray(JP.lda_predict(
        ref, jnp.asarray(t.numpy()))))
    skl = LinearDiscriminantAnalysis().fit(t.numpy(), y)
    np.testing.assert_array_equal(pred, skl.predict(t.numpy()))


def test_batched_masked_lda_equals_one_lda_a_mask(xy):
    """Every component count's LDA in one batched call over the (K, K)
    masks equals the JAX package's masked LDA of each mask."""
    x, y = xy
    kk = 6
    t = TP.pls_fit(x, y, kk, device="cpu").scores
    masks = (torch.arange(kk)[None, :] < torch.arange(1, kk + 1)[:, None]
             ).double()
    batched = TP.lda_fit(t, torch.as_tensor(y), 3, dim_mask=masks)
    preds = TP.lda_predict(batched, t, dim_mask=masks).numpy()
    assert preds.shape == (kk, len(y))
    for i in range(kk):
        m = jnp.asarray(masks[i].numpy())
        ref = JP.lda_fit(jnp.asarray(t.numpy()), jnp.asarray(y), 3,
                         dim_mask=m)
        for field in ("means", "cov_inv", "coef", "intercept"):
            _close(getattr(batched, field)[i], getattr(ref, field),
                   what=f"{field} k={i + 1}")
        np.testing.assert_array_equal(preds[i], np.asarray(JP.lda_predict(
            ref, jnp.asarray(t.numpy()), dim_mask=m)))


def test_f1_macro_matches_sklearn_and_jax(xy):
    _, y = xy
    rng = np.random.default_rng(2)
    pred = y.copy()
    flip = rng.integers(0, len(y), 30)
    pred[flip] = rng.integers(0, 3, 30)
    ours = float(TP.f1_macro(y, pred, 3))
    np.testing.assert_allclose(ours, f1_score(y, pred, average="macro"),
                               atol=1e-12)
    np.testing.assert_allclose(ours, float(JP.f1_macro(
        jnp.asarray(y), jnp.asarray(pred), 4 - 1)), atol=1e-12)
    # a class absent from both counts as 0; batched predictions
    both = np.stack([pred, y])
    np.testing.assert_allclose(TP.f1_macro(y, both, 4).numpy(),
                               [f1_score(y, p, labels=[0, 1, 2, 3],
                                         average="macro", zero_division=0)
                                for p in both],
                               atol=1e-12)


@pytest.mark.parametrize("n_splits,seed", [(5, 42), (4, 0), (3, None)])
def test_stratified_kfold_equals_jax(xy, n_splits, seed):
    _, y = xy
    ours = TP.stratified_kfold_indices(y, n_splits, random_state=seed)
    ref = JP.stratified_kfold_indices(y, n_splits, random_state=seed) \
        if seed is not None else ours
    for (tr, te), (rtr, rte) in zip(ours, ref):
        np.testing.assert_array_equal(tr, rtr)
        np.testing.assert_array_equal(te, rte)
    assert sorted(np.concatenate([te for _, te in ours])) == \
        list(range(len(y)))


@pytest.mark.parametrize("dataset", ["xy", "cheese"])
def test_f1_curves_fit_predict_and_vectors_match_jax(xy, cheese, dataset):
    if dataset == "xy":
        x, y = xy
        x_te, y_te, kmax, folds = x, y, 8, 4
    else:
        x, y, x_te, y_te = cheese
        kmax, folds = 12, 5
    ours = TP.plsda_f1_curves(x, y, max_components=kmax, n_folds=folds,
                              device="cpu")
    ref = JP.plsda_f1_curves(x, y, max_components=kmax, n_folds=folds)
    assert ours["best_n_components"] == ref["best_n_components"]
    for key in ("f1_cal", "f1_cv"):
        assert ours[key].shape == (kmax,)
        np.testing.assert_allclose(ours[key], ref[key], rtol=0, atol=1e-12)
    k = ours["best_n_components"]
    res = TP.plsda_fit_predict(x, y, x_te, y_te, k, device="cpu")
    jres = JP.plsda_fit_predict(x, y, x_te, y_te, k)
    np.testing.assert_array_equal(res.y_pred, jres.y_pred)
    np.testing.assert_array_equal(res.confusion, jres.confusion)
    np.testing.assert_allclose(res.f1_test, jres.f1_test, atol=1e-12)
    assert res.n_components == k and res.confusion.sum() == len(y_te)
    for field in ("weights", "loadings", "rotations", "scores"):
        _close(getattr(res.pls, field), getattr(jres.pls, field), what=field)
    _close(res.lda.coef, jres.lda.coef)
    d = TP.discriminant_vectors(res.pls, res.lda)
    _close(d, JP.discriminant_vectors(jres.pls, jres.lda))
    n_classes = int(max(y.max(), y_te.max())) + 1
    assert d.shape == (x.shape[1], n_classes - 1)
    np.testing.assert_allclose(np.linalg.norm(d, axis=0), 1.0, atol=1e-9)
    _close(TP.discriminant_vectors(res.pls, res.lda, variance_scaled=False),
           JP.discriminant_vectors(jres.pls, jres.lda, variance_scaled=False))
