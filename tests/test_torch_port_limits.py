"""Parity of the port's limit engines (``ocm_tpu_torch.stats.limits``) with
``ocm_tpu.stats.limits`` in float64: every T^2 method x Q method x
decision type, on a stack of three classes (the port broadcasts over the
leading class axis, the reference runs once per class)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocm_tpu.stats import limits as JL
from ocm_tpu_torch.stats import limits as TL

N_CLASSES, N, R, K, CL = 3, 120, 60, 4, 0.95
RTOL = 1e-8


@functools.lru_cache(maxsize=None)
def _stats():
    """Per class: training T^2 and Q, an eigenvalue spectrum, and scored
    T^2/Q; shaped like a fitted SIMCA model's statistics."""
    rng = np.random.default_rng(3)
    t2 = rng.chisquare(K, size=(N_CLASSES, N))
    q = rng.gamma(2.0, 0.01, size=(N_CLASSES, N))
    eig = np.sort(rng.gamma(1.0, 1.0, size=(N_CLASSES, R))
                  * np.logspace(0, -3, R), axis=-1)[:, ::-1].copy()
    t2_new = rng.chisquare(K, size=(N_CLASSES, 200)) * 1.5
    q_new = rng.gamma(2.0, 0.015, size=(N_CLASSES, 200))
    return t2, q, eig, t2_new, q_new


@functools.lru_cache(maxsize=None)
def _thetas():
    eig = _stats()[2]
    return (jax.vmap(lambda e: JL.residual_thetas(e, K))(jnp.asarray(eig)),
            TL.residual_thetas(torch.as_tensor(eig), K))


# The reference runs per class under vmap and jit, as its fits do; one
# compile per method keeps the file's time small.
@functools.partial(jax.jit, static_argnums=0)
def _ref_t2(method, t2):
    return jax.vmap(lambda v: JL.t2_limit(v, K, method, CL))(t2)


@functools.partial(jax.jit, static_argnums=0)
def _ref_q(method, q, thetas):
    return jax.vmap(lambda v, th: JL.q_limit(v, method, CL, thetas=th))(
        q, thetas)


@functools.partial(jax.jit, static_argnums=0)
def _ref_decision(decision_type, t2_res, q_res, thetas, t2_new, q_new):
    def one(t2_r, q_r, th, t2n, qn):
        return (JL.critical_distance(decision_type, t2_r, q_r, n_components=K,
                                     thetas=th, dcl=CL),
                JL.reduced_distance(decision_type, t2n, qn, t2_r, q_r))
    return jax.vmap(one)(t2_res, q_res, thetas, t2_new, q_new)


@functools.lru_cache(maxsize=None)
def _t2_limits(method):
    """(reference, port) T^2 limits of the three classes."""
    t2 = _stats()[0]
    return (_ref_t2(method, jnp.asarray(t2)),
            TL.t2_limit(torch.as_tensor(t2), K, method, CL))


@functools.lru_cache(maxsize=None)
def _q_limits(method):
    q = _stats()[1]
    ref_th, port_th = _thetas()
    return (_ref_q(method, jnp.asarray(q), ref_th),
            TL.q_limit(torch.as_tensor(q), method, CL, thetas=port_th))


def _assert_limit(ref, port):
    for field in ("limit", "dof", "scale"):
        np.testing.assert_allclose(getattr(port, field).numpy(),
                                   np.asarray(getattr(ref, field)),
                                   rtol=RTOL, err_msg=field)


def test_residual_thetas():
    eig = _stats()[2]
    got = TL.residual_thetas(torch.as_tensor(eig), K, max_rank=R - 5)
    for c in range(N_CLASSES):
        ref = JL.residual_thetas(jnp.asarray(eig[c]), K, max_rank=R - 5)
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g[c].item(), float(r), rtol=1e-12)


@pytest.mark.parametrize("method", TL.T2_METHODS)
def test_t2_limit(method):
    _assert_limit(*_t2_limits(method))


@pytest.mark.parametrize("method", TL.Q_METHODS)
def test_q_limit(method):
    _assert_limit(*_q_limits(method))


@pytest.mark.parametrize("decision_type", TL.DECISION_TYPES)
@pytest.mark.parametrize("q_method", TL.Q_METHODS)
@pytest.mark.parametrize("t2_method", TL.T2_METHODS)
def test_critical_and_reduced_distance(t2_method, q_method, decision_type):
    (ref_t2, t2_res), (ref_q, q_res) = _t2_limits(t2_method), _q_limits(q_method)
    ref_th, port_th = _thetas()
    _, _, _, t2_new, q_new = _stats()
    d_ref, dred_ref = _ref_decision(decision_type, ref_t2, ref_q, ref_th,
                                    jnp.asarray(t2_new), jnp.asarray(q_new))
    d_port = TL.critical_distance(decision_type, t2_res, q_res,
                                  n_components=K, thetas=port_th, dcl=CL)
    np.testing.assert_allclose(d_port.numpy(),
                               np.broadcast_to(d_ref, (N_CLASSES,)), rtol=RTOL)
    dred_port = TL.reduced_distance(decision_type, torch.as_tensor(t2_new),
                                    torch.as_tensor(q_new), t2_res, q_res)
    np.testing.assert_allclose(dred_port.numpy(), np.asarray(dred_ref),
                               rtol=RTOL)


def test_unknown_methods_raise():
    x = torch.ones(3, dtype=torch.float64)
    with pytest.raises(ValueError):
        TL.t2_limit(x, 1, "nope")
    with pytest.raises(ValueError):
        TL.q_limit(x, "nope")
    lim = TL.LimitResult(x, x, x)
    with pytest.raises(ValueError):
        TL.critical_distance("nope", lim, lim)
    with pytest.raises(ValueError):
        TL.reduced_distance("nope", x, x, lim, lim)
