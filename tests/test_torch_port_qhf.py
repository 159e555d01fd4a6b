"""The port's q/h/f statistics (``ocm_tpu_torch.stats.qhf``) and
``mahalanobis_sq`` against ``ocm_tpu``, float64 on the CPU, on seeded
numpy inputs.  Tolerance 1e-10 relative: eigh-based pseudo-inverses and
bisected chi^2 quantiles at non-integer dofs, in f64."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocm_tpu.ops import linalg as JL
from ocm_tpu.stats import qhf as JQ
from ocm_tpu_torch.ops import linalg as TL
from ocm_tpu_torch.stats import qhf as TQ

RTOL, ATOL = 1e-10, 1e-12
# (N, L, k): a calibration batch, a ragged one, and k = 1
SHAPES = [(60, 48, 4), (37, 20, 6), (25, 10, 1)]


def _inputs(n, length, k, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, length))
    x_rec = x + rng.normal(0, 0.3, size=(n, length))
    z = rng.normal(0.5, 1.2, size=(n, k)) @ rng.normal(size=(k, k))
    return x, x_rec, z


def _close(got, ref, what):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=RTOL, atol=ATOL,
                               err_msg=what)


def _t(*arrays):
    return [torch.tensor(a) for a in arrays]


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_moments_and_leverage_match_jax(shape):
    x, _, z = _inputs(*shape)
    q = (x ** 2).sum(1)
    for got, ref, what in zip(TQ._moment_dof(torch.tensor(q)),
                              JQ._moment_dof(jnp.asarray(q)), ("N", "mean")):
        _close(got, ref, what)
    _close(TQ._leverage_from_batch(torch.tensor(z)),
           JQ._leverage_from_batch(jnp.asarray(z)), "leverage")


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_qhf_batch_and_host_twin_match_jax(shape):
    x, x_rec, z = _inputs(*shape, seed=1)
    ref = JQ.qhf_batch(*(jnp.asarray(a) for a in (x, x_rec, z)))
    got = TQ.qhf_batch(*_t(x, x_rec, z))
    for name in JQ.QHFResult._fields:
        _close(getattr(got, name), getattr(ref, name), name)
    stats = TQ.qhf_stats(*_t(x, x_rec, z))
    for g, name in zip(stats, ("q", "h", "f")):
        _close(g, getattr(ref, name), f"qhf_stats {name}")
    for g, r, name in zip(TQ.qhf_batch_host(x, x_rec, z),
                          JQ.qhf_batch_host(x, x_rec, z), ("q", "h", "f")):
        _close(g, r, f"host {name}")


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_qhf_fit_and_calibrated_match_jax(shape):
    x, x_rec, z = _inputs(*shape, seed=2)
    xn, rn, zn = _inputs(*shape, seed=3)
    jcal = JQ.qhf_fit(*(jnp.asarray(a) for a in (x, x_rec, z)))
    tcal = TQ.qhf_fit(*_t(x, x_rec, z))
    for name in JQ.QHFCalibration._fields:
        _close(getattr(tcal, name), getattr(jcal, name), name)
    ref = JQ.qhf_calibrated(*(jnp.asarray(a) for a in (xn, rn, zn)), jcal)
    got = TQ.qhf_calibrated(*_t(xn, rn, zn), tcal)
    for name in JQ.QHFResult._fields:
        _close(getattr(got, name), getattr(ref, name), name)


@pytest.mark.parametrize("moments", [None, (2.5, 1.1, 30.0, 9.0)],
                         ids=["scored_set", "frozen"])
@pytest.mark.parametrize("alpha", [0.05, 0.01])
def test_full_distance_matches_jax(moments, alpha):
    rng = np.random.default_rng(4)
    mu = rng.normal(0.2, 1.0, size=(50, 4))
    mean = rng.normal(size=4)
    q = rng.gamma(3.0, 10.0, size=50)
    ref = JQ.full_distance(jnp.asarray(mu), jnp.asarray(mean), jnp.asarray(q),
                           alpha=alpha, moments=moments)
    got = TQ.full_distance(*_t(mu, mean, q), alpha=alpha, moments=moments)
    for name in JQ.FullDistanceResult._fields:
        _close(getattr(got, name), getattr(ref, name), name)


@pytest.mark.parametrize("shape", [(40, 4), (7, 16)], ids=str)
def test_mahalanobis_sq_matches_jax(shape):
    rng = np.random.default_rng(5)
    x = rng.normal(size=shape)
    mean = rng.normal(size=shape[1])
    a = rng.normal(size=(shape[1], shape[1]))
    cov_inv = a @ a.T + np.eye(shape[1])
    _close(TL.mahalanobis_sq(*_t(x, mean, cov_inv)),
           JL.mahalanobis_sq(x, mean, cov_inv), "d2")
    # leading batch (class) dimensions broadcast
    got = TL.mahalanobis_sq(*_t(np.stack([x, 2 * x]), np.stack([mean, mean]),
                                np.stack([cov_inv, cov_inv])))
    _close(got[1], JL.mahalanobis_sq(2 * x, mean, cov_inv), "batched")
