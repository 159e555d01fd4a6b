"""scikit-learn estimator facade over the port's cores (port of
``ocm_tpu/sklearn_api.py``).

The strict-parity wrappers (``models.simca.SIMCA``,
``models.vaesimca.VAESIMCA``) reproduce the reference API with its quirks;
this module is the idiomatic sklearn surface: estimators subclassing
``sklearn.base.BaseEstimator`` that compose with ``clone``,
``GridSearchCV``, ``cross_val_score`` and ``Pipeline``.

Conventions follow sklearn's outlier detectors: ``predict`` returns +1
(conforming) / -1, ``decision_function`` is positive inside the acceptance
region (the reference's strict ``<`` boundary), ``score_samples`` is the
negated reduced distance.  ``SIMCAClassifier.predict`` assigns each sample
to the class of smallest reduced distance; SIMCA's open-set accept matrix
is ``accept_matrix``.

Every estimator takes ``device`` (None: CUDA), stored as given so that
``clone`` and the searches keep it; inputs go to it as the port's entry
points take them (numpy float64 becomes float32 on the card).
scikit-learn is imported here, at module top, inside a ``try``: without
it the module still imports (stub bases) and ``fit`` raises
``ImportError``.  No other module of the port imports sklearn.
"""

from __future__ import annotations

import numpy as np

try:
    from sklearn.base import BaseEstimator, ClassifierMixin, OutlierMixin
    _HAVE_SKLEARN = True
except ImportError:
    _HAVE_SKLEARN = False

    class BaseEstimator:  # type: ignore[no-redef]
        pass

    class ClassifierMixin:  # type: ignore[no-redef]
        pass

    class OutlierMixin:  # type: ignore[no-redef]
        pass


def _require_sklearn():
    if not _HAVE_SKLEARN:
        raise ImportError(
            "scikit-learn is required for ocm_tpu_torch.sklearn_api; "
            "install scikit-learn or use the native wrappers in "
            "ocm_tpu_torch.models")


def _not_fitted(est, attr: str):
    if not hasattr(est, attr):
        from sklearn.exceptions import NotFittedError

        raise NotFittedError(
            f"This {type(est).__name__} instance is not fitted yet.")


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


class SIMCAOneClass(OutlierMixin, BaseEstimator):
    """One-class SIMCA with the sklearn outlier-detector API.

    ``fit(X)`` treats every row of X as the target class (pass only
    target-class spectra); ``decision_function`` is ``d_limit -
    reduced_distance``, ``score_samples`` is ``-reduced_distance``.
    Nothing is validated or changed before ``fit``, so ``clone`` and
    ``GridSearchCV`` see the constructor arguments as given.
    """

    def __init__(self, n_components: int = 2, decision_type: str = "alt",
                 t2lim: str = "Fdist", t2cl: float = 0.95,
                 qlim: str = "jm", qcl: float = 0.95, dcl: float = 0.95,
                 solver: str = "svd", dtype=None, device=None):
        self.n_components = n_components
        self.decision_type = decision_type
        self.t2lim = t2lim
        self.t2cl = t2cl
        self.qlim = qlim
        self.qcl = qcl
        self.dcl = dcl
        self.solver = solver
        self.dtype = dtype
        self.device = device

    def fit(self, X, y=None):
        _require_sklearn()
        from ocm_tpu_torch.models.simca import fit_simca

        X = np.asarray(X)
        if X.ndim != 2:
            raise ValueError("X must be 2-D (n_samples, length)")
        self.model_ = fit_simca(
            X, self.n_components, self.decision_type, self.t2lim,
            self.qlim, self.t2cl, self.qcl, self.dcl, dtype=self.dtype,
            solver=self.solver, device=self.device)
        self.n_features_in_ = X.shape[1]
        return self

    def _dred(self, X):
        from ocm_tpu_torch.models.simca import simca_decide

        _, dred, _, _ = simca_decide(self.model_, np.asarray(X),
                                     self.decision_type)
        return _host(dred)

    def decision_function(self, X):
        _not_fitted(self, "model_")
        return float(self.model_.d_limit) - self._dred(X)

    def score_samples(self, X):
        _not_fitted(self, "model_")
        return -self._dred(X)

    def predict(self, X):
        return np.where(self.decision_function(X) > 0.0, 1, -1)


class SIMCAClassifier(ClassifierMixin, BaseEstimator):
    """Multi-class SIMCA as an sklearn classifier.

    ``fit(X, y)`` fits one model per label of ``np.unique(y)`` as one
    batched solve (``models.simca.fit_classes``; unequal class sizes take
    the masked fit).  ``predict`` assigns the class of smallest reduced
    distance; ``decision_function`` is the (N, C) margin ``d_limit_c -
    dred_c``; ``accept_matrix`` is SIMCA's open-set (N, C) decision.
    """

    def __init__(self, n_components: int = 2, decision_type: str = "alt",
                 t2lim: str = "Fdist", t2cl: float = 0.95,
                 qlim: str = "jm", qcl: float = 0.95, dcl: float = 0.95,
                 solver: str = "svd", dtype=None, device=None):
        self.n_components = n_components
        self.decision_type = decision_type
        self.t2lim = t2lim
        self.t2cl = t2cl
        self.qlim = qlim
        self.qcl = qcl
        self.dcl = dcl
        self.solver = solver
        self.dtype = dtype
        self.device = device

    def fit(self, X, y):
        _require_sklearn()
        from ocm_tpu_torch.models.simca import fit_classes

        X = np.asarray(X)
        y = np.asarray(y)
        if X.ndim != 2:
            raise ValueError("X must be 2-D (n_samples, length)")
        if y.shape[0] != X.shape[0]:
            raise ValueError("X and y have inconsistent lengths")
        self.classes_ = np.unique(y)
        if self.classes_.shape[0] < 2:
            raise ValueError(
                "SIMCAClassifier needs >= 2 classes in y; for a single "
                "target class use SIMCAOneClass")
        kwargs = dict(decision_type=self.decision_type,
                      t2_method=self.t2lim, q_method=self.qlim,
                      t2_cl=self.t2cl, q_cl=self.qcl, d_cl=self.dcl,
                      solver=self.solver)
        if len({int(np.sum(y == c)) for c in self.classes_}) > 1:
            # unequal class sizes take the masked fit, whose dense solver
            # is the Gram-side eigh ('svd' is the dense path's name for
            # the same decomposition); it fits in the data's own dtype
            if self.dtype is not None:
                import warnings

                warnings.warn(
                    "SIMCAClassifier(dtype=...) is ignored when class "
                    "sizes are unequal: the masked batched fit "
                    "standardizes its own compute dtype", UserWarning,
                    stacklevel=2)
            if kwargs["solver"] == "svd":
                kwargs["solver"] = "eigh"
        else:
            kwargs["dtype"] = self.dtype
        self.models_ = fit_classes(X, y, list(self.classes_),
                                   self.n_components, device=self.device,
                                   **kwargs)
        self.n_features_in_ = X.shape[1]
        return self

    def _scores(self, X):
        """(accept, dred), each (C, N), from one fused multi-class pass."""
        from ocm_tpu_torch.models.simca import predict_classes

        accept, dred, _, _ = predict_classes(self.models_, np.asarray(X),
                                             self.decision_type)
        return _host(accept), _host(dred)

    def decision_function(self, X):
        _not_fitted(self, "models_")
        _, dred = self._scores(X)
        return (_host(self.models_.d_limit)[:, None] - dred).T

    def predict(self, X):
        _not_fitted(self, "models_")
        _, dred = self._scores(X)
        return self.classes_[np.argmin(dred, axis=0)]

    def accept_matrix(self, X):
        """(N, C) boolean acceptance: a sample may be accepted by several
        classes or none (the reference's ``SIMCA.predict`` as 0/1)."""
        _not_fitted(self, "models_")
        return self._scores(X)[0].T


def neg_val_loss(estimator, X=None, y=None):
    """Scoring callable for ``GridSearchCV``/``RandomizedSearchCV`` over
    ``VAESIMCAOneClass``: the negated best validation loss of the
    estimator's own cal/val split (sklearn maximizes), the objective of
    ``utils.tpe.tpe_vae_search``.  The test fold is ignored: pass one
    trivial split such as ``cv=[(np.arange(n), np.arange(2))]``."""
    return -float(np.min(estimator.val_losses_))


class VAESIMCAOneClass(OutlierMixin, BaseEstimator):
    """Train-and-calibrate VAE-SIMCA (decision variant 5) as one sklearn
    outlier detector.

    ``fit(X)`` trains a ``ConvVAE1D`` on a cal/val split of X in float32,
    as the reference does (``models.trainer.train_vae``, its best
    validation epoch, seeded by ``random_state``), and fits the
    latent-SIMCA limits on the calibration rows
    (``models.vaesimca.fit_vaesimca``).  ``val_indices`` pins the
    validation rows; otherwise they are a seeded permutation's first
    ``val_fraction``.  ``decision_function`` is ``d_limit - reduced_d``.
    """

    def __init__(self, latent_dim: int = 8, conv_blocks: int = 2,
                 n_filters: int = 8, hidden_fc: int = 32,
                 epochs: int = 30, batch_size: int = 64, lr: float = 1e-3,
                 beta: float = 1.0, loss_type: str = "bce",
                 decision_type: str = "alt", t2lim: str = "Fdist",
                 t2cl: float = 0.95, qlim: str = "jm", qcl: float = 0.95,
                 dcl: float = 0.95, classical_limits: bool = False,
                 val_fraction: float = 0.15, val_indices=None,
                 random_state: int = 0, device=None):
        self.latent_dim = latent_dim
        self.conv_blocks = conv_blocks
        self.n_filters = n_filters
        self.hidden_fc = hidden_fc
        self.epochs = epochs
        self.batch_size = batch_size
        self.lr = lr
        self.beta = beta
        self.loss_type = loss_type
        self.decision_type = decision_type
        self.t2lim = t2lim
        self.t2cl = t2cl
        self.qlim = qlim
        self.qcl = qcl
        self.dcl = dcl
        self.classical_limits = classical_limits
        self.val_fraction = val_fraction
        self.val_indices = val_indices
        self.random_state = random_state
        self.device = device

    def _split(self, X):
        n = X.shape[0]
        if self.val_indices is not None:
            val_idx = np.asarray(self.val_indices, dtype=np.intp)
            if val_idx.size == 0 or val_idx.min() < 0 or val_idx.max() >= n:
                raise ValueError(
                    f"val_indices must be non-empty row indices into X "
                    f"(n_samples={n})")
            mask = np.zeros(n, dtype=bool)
            mask[val_idx] = True
            if (~mask).sum() < 2:
                raise ValueError(
                    f"val_indices leaves {(~mask).sum()} calibration "
                    f"rows; need >= 2")
            return X[~mask], X[mask]
        n_val = max(1, int(round(self.val_fraction * n)))
        if n - n_val < 2:
            raise ValueError(f"n_samples={n} too small for val_fraction="
                             f"{self.val_fraction}")
        perm = np.random.default_rng(self.random_state).permutation(n)
        return X[perm[n_val:]], X[perm[:n_val]]

    def fit(self, X, y=None):
        _require_sklearn()
        from ocm_tpu_torch.models.stacked import seeded_vae
        from ocm_tpu_torch.models.trainer import TrainConfig, train_vae
        from ocm_tpu_torch.models.vae import ConvVAE1D
        from ocm_tpu_torch.models.vaesimca import fit_vaesimca

        X = np.asarray(X, dtype=np.float32)
        if X.ndim != 2:
            raise ValueError("X must be 2-D (n_samples, length)")
        x_cal, x_val = self._split(X)
        seed = int(self.random_state)
        self.network_ = seeded_vae(ConvVAE1D(
            input_length=X.shape[1], latent_dim=self.latent_dim,
            conv_blocks=self.conv_blocks, n_filters=self.n_filters,
            hidden_fc=self.hidden_fc), seed)
        cfg = TrainConfig(epochs=self.epochs, batch_size=self.batch_size,
                          lr=float(self.lr), beta=float(self.beta),
                          loss_type=self.loss_type)
        result = train_vae(self.network_, x_cal, x_val, cfg, seed,
                           device=self.device)
        self.bundle_ = result.bundle
        self.train_losses_ = np.asarray(result.train_losses)
        self.val_losses_ = np.asarray(result.val_losses)
        self.best_epoch_ = int(result.best_epoch)
        self.vs_ = fit_vaesimca(
            self.network_, self.bundle_, x_cal, self.decision_type,
            self.t2lim, self.t2cl, self.qlim, self.qcl, self.dcl,
            classical_limits=self.classical_limits)
        self.n_features_in_ = X.shape[1]
        return self

    def decision_function(self, X):
        _not_fitted(self, "vs_")
        from ocm_tpu_torch.models.vaesimca import predict_vaesimca, reduced_d

        _, t2, q = predict_vaesimca(self.network_, self.bundle_, self.vs_,
                                    np.asarray(X, np.float32),
                                    self.decision_type)
        d = reduced_d(self.vs_, t2, q, self.decision_type)
        return float(self.vs_.d_limit) - _host(d)

    def score_samples(self, X):
        return self.decision_function(X)

    def predict(self, X):
        return np.where(self.decision_function(X) > 0.0, 1, -1)
