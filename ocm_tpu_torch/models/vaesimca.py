"""VAE-SIMCA: SIMCA limits in the VAE's latent space, variant 5 (port of
``ocm_tpu/models/vaesimca.py``).

T^2 = Mahalanobis of the encoder's mu against the calibration latent
distribution; Q = the latent round-trip residual ``||z - encode(decode(z))||^2``;
limits and the combined decision per SIMCA decision type.

The reference's limit engines here differ on purpose from the classical
ones under the same names (quirk Q5), and the port keeps every formula:

- T2 'Fdist' scales an empirical percentile by k(n-1)/(n-k); 'chi2' is a
  plain percentile;
- T2/Q 'chi2pom' scale a percentile by mean/dof instead of a chi^2 quantile;
- Q 'jm' takes theta moments of the Q values themselves;
- D 'ci' multiplies by a Q percentile; 'dd' is t2 dof + q dof.

``classical_limits=True`` takes the T2/Q limits and the critical distance
from ``stats/limits.py`` instead ('jm' stays the Q-value-moment variant).
``compat_double_standardize`` (on by default) reproduces the reference's
second standardization of the decoder's already standardized output
before re-encoding.

Entry points run on ``bundle.bind(model, bundle)`` under
``torch.inference_mode()``, on the bundle's device.
``save_vaesimca_model``/``load_vaesimca_model`` write and read the JAX
package's msgpack file of the fitted state.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ocm_tpu_torch._device import resolve_device
from ocm_tpu_torch.models.bundle import (OCMBundle, bind, encode,
                                         inference_entry, standardize)
from ocm_tpu_torch.models.vae import ConvVAE1D
from ocm_tpu_torch.ops.linalg import mahalanobis_sq, pinv_psd
from ocm_tpu_torch.ops.special import erfinv
from ocm_tpu_torch.stats import limits as L
from ocm_tpu_torch.utils import msgpack_io


class VAESIMCAModel(NamedTuple):
    """Per-class latent SIMCA state."""

    latent_mean: torch.Tensor
    invcovT: torch.Tensor
    t2_limit: torch.Tensor
    q_limit: torch.Tensor
    d_limit: torch.Tensor
    t2_dof: torch.Tensor
    t2_scale: torch.Tensor
    q_dof: torch.Tensor
    q_scale: torch.Tensor
    n_components: torch.Tensor


def _t2_limit(t2, n_components, method: str, cl: float):
    """(limit, dof, scale) of T^2 (quirk Q5 formulas)."""
    n = t2.shape[0]
    perc = L.quantile(t2, cl)
    one = torch.ones((), dtype=t2.dtype, device=t2.device)
    if method in ("perc", "chi2"):
        return perc, one, one
    if method == "Fdist":
        k = n_components
        return k * (n - 1.0) / (n - k) * perc, one, one
    if method == "chi2pom":
        h0 = t2.mean()
        var = t2.var(correction=1) if n > 1 else torch.zeros_like(h0)
        nh = torch.where(var > 0, torch.round(2.0 * h0 * h0 / var),
                         1.0).clamp_min(1.0)
        return h0 * perc / nh, nh, h0
    raise ValueError(f"T2 limit type {method!r} not implemented")


def _q_limit(q, method: str, cl: float):
    """(limit, dof, scale) of Q (theta moments of the Q values, quirk Q5)."""
    one = torch.ones((), dtype=q.dtype, device=q.device)
    if method == "perc":
        return L.quantile(q, cl), one, one
    if method == "jm":
        theta1, theta2, theta3 = q.sum(), (q * q).sum(), (q ** 3).sum()
        safe1 = torch.where(theta1 > 0, theta1, 1.0)
        safe2 = torch.where(theta2 > 0, theta2, 1.0)
        h0 = (1.0 - (2.0 * theta1 * theta3) / (3.0 * safe2 * safe2)
              ).clamp_min(1e-3)
        ca = math.sqrt(2.0) * erfinv(one * (2.0 * cl - 1.0))
        h1 = ca * torch.sqrt(2.0 * theta2 * h0 * h0) / safe1
        h2 = theta2 * h0 * (h0 - 1.0) / (safe1 * safe1)
        lim = theta1 * (1.0 + h1 + h2) ** (1.0 / h0)
        return torch.where(theta1 > 0, lim, 0.0), one, one
    if method == "chi2pom":
        v0 = q.mean()
        nv = torch.round(2.0 * v0 * v0 / q.var(correction=1)).clamp_min(1.0)
        return v0 * L.quantile(q, cl) / nv, nv, v0
    raise ValueError(f"Q limit type {method!r} not implemented")


def _d_limit(decision_type: str, t2_limit, q_limit, t2, q, n_components,
             t2_dof, q_dof, dcl: float):
    """The critical distance (quirk Q5: 'ci' uses a Q percentile, 'dd' is
    the dof sum)."""
    if decision_type == "sim":
        return torch.ones((), dtype=t2.dtype, device=t2.device)
    if decision_type == "alt":
        return torch.full((), math.sqrt(2.0), dtype=t2.dtype,
                          device=t2.device)
    if decision_type == "ci":
        tr1 = n_components / t2_limit + q.sum() / q_limit
        tr2 = (n_components / (t2_limit * t2_limit)
               + (q * q).sum() / (q_limit * q_limit))
        return tr2 / tr1 * L.quantile(q, dcl)
    if decision_type == "dd":
        return t2_dof + q_dof
    raise ValueError(f"D type {decision_type!r} not implemented")


def _latent_roundtrip_q(model: ConvVAE1D, bundle: OCMBundle, z,
                        compat_double_standardize: bool):
    """Q = ||z - encode(decode(z))||^2 through the module itself: its
    ``decode`` returns standardized spectra, standardized once more under
    ``compat_double_standardize``, and its ``encode`` takes them as they
    are.  The residual is summed in f32 or wider."""
    module = bind(model, bundle)
    x_hat_std = module.decode(z)
    if compat_double_standardize:
        x_hat_std = standardize(bundle, x_hat_std)
    z_hat, _ = module.encode(x_hat_std)
    acc = torch.promote_types(z.dtype, torch.float32)
    return ((z.to(acc) - z_hat.to(acc)) ** 2).sum(1)


@inference_entry
def fit_vaesimca(model: ConvVAE1D, bundle: OCMBundle, x_cal,
                 decision_type: str = "alt", t2lim: str = "Fdist",
                 t2cl: float = 0.95, qlim: str = "jm", qcl: float = 0.95,
                 dcl: float = 0.95,
                 compat_double_standardize: bool = True,
                 classical_limits: bool = False) -> VAESIMCAModel:
    """Fit the latent-SIMCA limits on the calibration set.

    ``classical_limits=True`` corrects quirk Q5: the T2/Q limits come from
    ``stats.limits`` (true F/chi^2 quantiles, chi^2-based critical
    distances); 'jm' stays the Q-value-moment variant (latent residuals
    have no eigenvalue spectrum).
    """
    mu, _ = encode(model, bundle, x_cal)
    k = mu.shape[1]
    latent_mean = mu.mean(0)
    muc = mu - latent_mean[None, :]
    cov = (muc.T @ muc) / (mu.shape[0] - 1) + 1e-12 * torch.eye(
        k, dtype=mu.dtype, device=mu.device)
    invcovT = pinv_psd(cov)
    t2 = mahalanobis_sq(mu, latent_mean, invcovT)
    q = _latent_roundtrip_q(model, bundle, mu, compat_double_standardize)
    n_comp = torch.tensor(k, device=mu.device)
    if classical_limits:
        t2_res = L.t2_limit(t2, k, t2lim, t2cl)
        if qlim == "jm":
            q_res = L.LimitResult(*_q_limit(q, qlim, qcl))
        else:
            q_res = L.q_limit(q, qlim, qcl)
        d_limit = L.critical_distance(
            decision_type, t2_res, q_res, n_components=k,
            thetas=(q.sum(), (q * q).sum(), (q ** 3).sum()), dcl=dcl)
        return VAESIMCAModel(latent_mean, invcovT, t2_res.limit,
                             q_res.limit, d_limit, t2_res.dof, t2_res.scale,
                             q_res.dof, q_res.scale, n_comp)
    t2_limit, t2_dof, t2_scale = _t2_limit(t2, k, t2lim, t2cl)
    q_limit, q_dof, q_scale = _q_limit(q, qlim, qcl)
    d_limit = _d_limit(decision_type, t2_limit, q_limit, t2, q, k,
                       t2_dof, q_dof, dcl)
    return VAESIMCAModel(latent_mean, invcovT, t2_limit, q_limit, d_limit,
                         t2_dof, t2_scale, q_dof, q_scale, n_comp)


@inference_entry
def predict_vaesimca(model: ConvVAE1D, bundle: OCMBundle,
                     vs: VAESIMCAModel, x, decision_type: str = "alt",
                     compat_double_standardize: bool = True):
    """(accept, T2, Q) of new spectra."""
    mu, _ = encode(model, bundle, x)
    mu32 = mu.to(torch.promote_types(mu.dtype, torch.float32))
    t2 = mahalanobis_sq(mu32, vs.latent_mean, vs.invcovT)
    q = _latent_roundtrip_q(model, bundle, mu, compat_double_standardize)
    return reduced_d(vs, t2, q, decision_type) < vs.d_limit, t2, q


def reduced_d(vs: VAESIMCAModel, t2, q, decision_type: str = "alt"):
    """The combined reduced distance compared with ``vs.d_limit`` (the
    decision is ``reduced_d(...) < vs.d_limit``)."""
    if decision_type == "alt":
        return torch.sqrt((t2 / vs.t2_limit) ** 2 + (q / vs.q_limit) ** 2)
    if decision_type == "dd":
        return t2 * vs.t2_dof / vs.t2_scale + q * vs.q_dof / vs.q_scale
    return torch.maximum(t2 / vs.t2_limit, q / vs.q_limit)


class VAESIMCA:
    """Estimator-style wrapper of the reference's VAE_SIMCA class."""

    def __init__(self, model: ConvVAE1D, bundle: OCMBundle, type: str = "alt",
                 t2lim: str = "Fdist", t2cl: float = 0.95, qlim: str = "jm",
                 qcl: float = 0.95, dcl: float = 0.95, verbose: bool = True,
                 compat_double_standardize: bool = True):
        self.model = model
        self.bundle = bundle
        self.type = type
        self.t2lim = t2lim
        self.t2cl = t2cl
        self.qlim = qlim
        self.qcl = qcl
        self.dcl = dcl
        self.verbose = verbose
        self.compat_double_standardize = compat_double_standardize
        self._model = {}
        self.model_class = None

    def fit_thresholds(self, x_cal, class_label: int = 0):
        self.model_class = [class_label]
        self._model[class_label] = fit_vaesimca(
            self.model, self.bundle, x_cal, self.type, self.t2lim, self.t2cl,
            self.qlim, self.qcl, self.dcl, self.compat_double_standardize)
        return self

    def predict(self, x):
        if not self._model:
            raise RuntimeError("call fit_thresholds before predict")
        vs = self._model[self.model_class[0]]
        return predict_vaesimca(self.model, self.bundle, vs, x, self.type,
                                self.compat_double_standardize)


def vaesimca_model_from_numpy(tree, device=None) -> VAESIMCAModel:
    """A ``VAESIMCAModel`` of either package as numpy (its fields as a
    mapping, or the model itself) on ``device`` (CUDA unless given)."""
    tree = tree._asdict() if hasattr(tree, "_asdict") else dict(tree)
    device = resolve_device(device)
    return VAESIMCAModel(**{f: torch.as_tensor(np.array(tree[f]),
                                               device=device)
                            for f in VAESIMCAModel._fields})


def save_vaesimca_model(path, vs: VAESIMCAModel) -> str:
    """Write a (possibly class-stacked) fitted latent-SIMCA state to one
    msgpack file in the JAX package's layout (field -> array), byte-equal
    to what it writes for the same arrays.  Returns ``path``."""
    msgpack_io.save(path, {f: getattr(vs, f).detach().cpu().numpy()
                           for f in vs._fields})
    return path


def load_vaesimca_model(path, device=None) -> VAESIMCAModel:
    """A state written by either package's ``save_vaesimca_model``, on
    ``device`` (CUDA unless given)."""
    return vaesimca_model_from_numpy(msgpack_io.load(path), device)
