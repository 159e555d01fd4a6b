"""The port's sklearn facade (``ocm_tpu_torch/sklearn_api.py``) against
``ocm_tpu.sklearn_api`` on the same float64 inputs, the port on the CPU
(``device="cpu"``, stored as a constructor parameter):
``decision_function``, ``predict`` and ``accept_matrix`` of the SIMCA
estimators within 1e-8 (equal, unequal and explicit-dtype fits), the
sklearn contracts (``clone``, ``GridSearchCV``, ``cross_val_score``,
``RandomizedSearchCV`` with ``neg_val_loss``), and ``VAESIMCAOneClass``
against the port's own ``train_vae`` + ``fit_vaesimca`` at the same seed
(JAX's random streams cannot be replayed in torch)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn.base import clone
from sklearn.exceptions import NotFittedError
from sklearn.model_selection import GridSearchCV, cross_val_score

from ocm_tpu import sklearn_api as J
from ocm_tpu_torch import sklearn_api as T

L = 40
CPU = "cpu"


@pytest.fixture(scope="module")
def blobs():
    rng = np.random.default_rng(7)
    grid = np.linspace(0, 1, L)
    means = [np.sin(6 * grid), np.cos(6 * grid), 1.5 * grid]
    xs, ys = [], []
    for c, m in enumerate(means):
        xs.append(m[None, :] + 0.08 * rng.standard_normal((24, L)))
        ys.append(np.full(24, c))
    return np.concatenate(xs).astype(np.float64), np.concatenate(ys)


def _close(got, ref, tol=1e-8):
    ref = np.asarray(ref, np.float64)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=tol * max(np.abs(ref).max(), 1.0))


@pytest.mark.parametrize("decision_type", ["alt", "dd"])
def test_one_class_matches_reference(blobs, decision_type):
    X, y = blobs
    kw = dict(n_components=3, decision_type=decision_type)
    if decision_type == "dd":
        kw.update(t2lim="chi2pom", qlim="chi2pom")
    est = T.SIMCAOneClass(**kw, device=CPU)
    with pytest.raises(NotFittedError):
        est.predict(X)
    est.fit(X[y == 0])
    ref = J.SIMCAOneClass(**kw).fit(X[y == 0])
    df = est.decision_function(X)
    assert df.shape == (X.shape[0],)
    _close(df, ref.decision_function(X))
    np.testing.assert_array_equal(est.predict(X), ref.predict(X))
    np.testing.assert_array_equal(est.predict(X), np.where(df > 0, 1, -1))
    _close(est.score_samples(X), ref.score_samples(X))
    np.testing.assert_allclose(est.score_samples(X),
                               df - float(est.model_.d_limit), rtol=1e-12)
    c = clone(est)
    assert c.get_params() == est.get_params() and c.device == CPU
    assert not hasattr(c, "model_")


def test_one_class_fit_predict_mixin(blobs):
    X, y = blobs
    fp = T.SIMCAOneClass(n_components=2, device=CPU).fit_predict(X[y == 1])
    np.testing.assert_array_equal(
        fp, J.SIMCAOneClass(n_components=2).fit_predict(X[y == 1]))
    assert (fp == 1).mean() > 0.8


@pytest.mark.parametrize("case", ["equal", "unequal", "dtype"])
def test_classifier_matches_reference(blobs, case):
    X, y = blobs
    if case == "unequal":
        keep = np.ones(len(y), bool)
        keep[np.where(y == 2)[0][:7]] = False      # class sizes 24/24/17
        X, y = X[keep], y[keep]
    tkw = jkw = {}
    if case == "dtype":
        tkw, jkw = {"dtype": torch.float32}, {"dtype": jnp.float32}
    est = T.SIMCAClassifier(n_components=3, device=CPU, **tkw).fit(X, y)
    ref = J.SIMCAClassifier(n_components=3, **jkw).fit(X, y)
    tol = 1e-4 if case == "dtype" else 1e-8
    _close(est.decision_function(X), ref.decision_function(X), tol)
    np.testing.assert_array_equal(est.predict(X), ref.predict(X))
    np.testing.assert_array_equal(est.accept_matrix(X),
                                  ref.accept_matrix(X))
    assert est.accept_matrix(X).shape == (X.shape[0], 3)
    assert (est.predict(X) == y).mean() > 0.9


def test_classifier_gridsearch_and_cv(blobs):
    X, y = blobs
    gs = GridSearchCV(T.SIMCAClassifier(device=CPU),
                      {"n_components": [2, 4]}, cv=2, error_score="raise")
    gs.fit(X, y)
    ref = GridSearchCV(J.SIMCAClassifier(), {"n_components": [2, 4]}, cv=2,
                       error_score="raise").fit(X, y)
    assert gs.best_params_ == ref.best_params_
    assert gs.best_estimator_.device == CPU
    np.testing.assert_allclose(gs.cv_results_["mean_test_score"],
                               ref.cv_results_["mean_test_score"],
                               rtol=1e-12)
    scores = cross_val_score(T.SIMCAClassifier(n_components=2, device=CPU),
                             X, y, cv=2, error_score="raise")
    np.testing.assert_allclose(scores, cross_val_score(
        J.SIMCAClassifier(n_components=2), X, y, cv=2), rtol=1e-12)


def test_classifier_validation(blobs):
    X, y = blobs
    with pytest.raises(ValueError, match=">= 2 classes"):
        T.SIMCAClassifier(device=CPU).fit(X[y == 0], y[y == 0])
    with pytest.raises(ValueError, match="inconsistent lengths"):
        T.SIMCAClassifier(device=CPU).fit(X, y[:-1])
    with pytest.raises(ValueError, match="2-D"):
        T.SIMCAClassifier(device=CPU).fit(X[0], y[:1])
    with pytest.raises(NotFittedError):
        T.SIMCAClassifier().predict(X)


def test_classifier_unequal_sizes_warns_on_dtype(blobs):
    import warnings

    X, y = blobs
    Xu, yu = X[3:], y[3:]
    with pytest.warns(UserWarning, match="dtype.*ignored"):
        T.SIMCAClassifier(n_components=3, dtype=torch.float32,
                          device=CPU).fit(Xu, yu)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        T.SIMCAClassifier(n_components=3, device=CPU).fit(Xu, yu)


VAE_KW = dict(latent_dim=3, conv_blocks=2, n_filters=4, hidden_fc=16,
              epochs=2, batch_size=16, random_state=3, device=CPU)


def _native_fit(x0, val_idx=None):
    """The port's own train_vae + fit_vaesimca on the estimator's split."""
    from ocm_tpu_torch.models.stacked import seeded_vae
    from ocm_tpu_torch.models.trainer import TrainConfig, train_vae
    from ocm_tpu_torch.models.vae import ConvVAE1D
    from ocm_tpu_torch.models.vaesimca import fit_vaesimca

    n = x0.shape[0]
    if val_idx is None:
        perm = np.random.default_rng(3).permutation(n)
        n_val = max(1, int(round(0.15 * n)))
        x_val, x_cal = x0[perm[:n_val]], x0[perm[n_val:]]
    else:
        mask = np.zeros(n, bool)
        mask[val_idx] = True
        x_val, x_cal = x0[mask], x0[~mask]
    net = seeded_vae(ConvVAE1D(L, 3, conv_blocks=2, n_filters=4,
                               hidden_fc=16), 3)
    r = train_vae(net, x_cal, x_val, TrainConfig(epochs=2, batch_size=16,
                                                 loss_type="bce"), 3,
                  device=CPU)
    return net, r, fit_vaesimca(net, r.bundle, x_cal)


def test_vaesimca_one_class_matches_native_path(blobs):
    from ocm_tpu_torch.models.vaesimca import predict_vaesimca

    X, y = blobs
    x0 = X[y == 0].astype(np.float32)
    est = T.VAESIMCAOneClass(**VAE_KW)
    with pytest.raises(NotFittedError):
        est.predict(x0)
    est.fit(x0)
    net, r, vs = _native_fit(x0)
    np.testing.assert_array_equal(est.train_losses_, r.train_losses)
    np.testing.assert_array_equal(est.val_losses_, r.val_losses)
    assert est.best_epoch_ == r.best_epoch
    df = est.decision_function(X)
    assert df.shape == (X.shape[0],) and np.isfinite(df).all()
    np.testing.assert_array_equal(est.predict(X), np.where(df > 0, 1, -1))
    accept = predict_vaesimca(net, r.bundle, vs, X.astype(np.float32))[0]
    np.testing.assert_array_equal(est.predict(X) == 1, accept.numpy())
    c = clone(est)
    assert c.get_params()["latent_dim"] == 3 and c.device == CPU
    assert not hasattr(c, "vs_")


def test_randomized_search_cv_end_to_end(blobs):
    from scipy.stats import loguniform
    from sklearn.model_selection import RandomizedSearchCV

    X, y = blobs
    x0 = X[y == 0].astype(np.float32)
    n = x0.shape[0]
    base = T.VAESIMCAOneClass(**VAE_KW, val_indices=np.arange(n - 6, n))
    search = RandomizedSearchCV(
        base, {"lr": loguniform(1e-4, 1e-2), "beta": loguniform(1e-2, 2.0)},
        n_iter=3, scoring=T.neg_val_loss, cv=[(np.arange(n), np.arange(2))],
        random_state=11, refit=True, error_score="raise")
    search.fit(x0)
    scores = search.cv_results_["mean_test_score"]
    assert scores.shape == (3,) and np.isfinite(scores).all()
    assert search.best_score_ == scores.max()
    assert T.neg_val_loss(search.best_estimator_) == search.best_score_
    assert search.best_estimator_.device == CPU
    assert set(np.unique(search.best_estimator_.predict(x0))) <= {-1, 1}


def test_val_indices_pins_the_split(blobs):
    X, y = blobs
    x0 = X[y == 0].astype(np.float32)
    n = x0.shape[0]
    est = T.VAESIMCAOneClass(**VAE_KW, val_indices=np.arange(4)).fit(x0)
    _, r, _ = _native_fit(x0, np.arange(4))
    np.testing.assert_array_equal(est.val_losses_, r.val_losses)
    with pytest.raises(ValueError, match="val_indices"):
        T.VAESIMCAOneClass(val_indices=np.array([n + 3])).fit(x0)
    with pytest.raises(ValueError, match="calibration"):
        T.VAESIMCAOneClass(val_indices=np.arange(n - 1)).fit(x0)


def test_estimators_default_to_cuda(blobs):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    X, y = blobs
    with pytest.raises(RuntimeError, match="CUDA"):
        T.SIMCAOneClass(n_components=2).fit(X[y == 0])
    with pytest.raises(RuntimeError, match="CUDA"):
        T.SIMCAClassifier(n_components=2).fit(X, y)
