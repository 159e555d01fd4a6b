"""Parity of the port's linear algebra (``ocm_tpu_torch.ops.linalg``) and of
the scoring kernel's plain twin (``ocm_tpu_torch.ops.kernels``) with
``ocm_tpu``: float64 on the CPU, and float32 against the Pallas kernel in
interpret mode."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocm_tpu.models.simca import fit_simca as jax_fit_simca
from ocm_tpu.ops import linalg as JA
from ocm_tpu.ops.kernels import t2_q_scores_pallas
from ocm_tpu_torch.ops import linalg as TA
from ocm_tpu_torch.ops.kernels import (t2q_scores_multiclass,
                                       t2q_scores_multiclass_plain)
from torch_port_data import K, make_data


@functools.lru_cache(maxsize=None)
def _data():
    return make_data(seed=1)


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _cov_of(x):
    xc = x - x.mean(0)
    return xc.T @ xc / (x.shape[0] - 1)


def test_pca_fit_matches_jax():
    x = _data()[0][0]
    ref = JA.pca_fit(jnp.asarray(x))
    got = TA.pca_fit(torch.as_tensor(x))
    np.testing.assert_allclose(_np(got.eigenvalues), _np(ref.eigenvalues),
                               rtol=1e-10, atol=1e-10 * float(ref.eigenvalues[0]))
    np.testing.assert_allclose(_np(got.mean), _np(ref.mean), rtol=1e-12)
    # components with their signs, on the well-separated leading directions
    np.testing.assert_allclose(_np(got.components[:K]), _np(ref.components[:K]),
                               atol=1e-8)
    np.testing.assert_allclose(_np(got.scores[:, :K]), _np(ref.scores[:, :K]),
                               atol=1e-8)


def test_pca_fit_batched_equals_per_class():
    cals = _data()[0]
    got = TA.pca_fit(torch.as_tensor(cals))
    for c in range(cals.shape[0]):
        one = TA.pca_fit(torch.as_tensor(cals[c]))
        np.testing.assert_allclose(_np(got.eigenvalues[c]),
                                   _np(one.eigenvalues), rtol=1e-12)


@pytest.mark.parametrize("name", ["cov", "pinv_psd", "eigh_desc_signed",
                                  "sign_columns", "svd_flip_signs",
                                  "sym_orthonormalize"])
def test_small_functions_match_jax(name):
    x = _data()[0][0]
    rng = np.random.default_rng(5)
    c = _cov_of(x)
    y = rng.normal(size=(x.shape[1], 6))
    scores = np.array(JA.pca_fit(jnp.asarray(x)).scores[:, :K])
    args = {
        "cov": (x,),
        "pinv_psd": (_cov_of(scores),),
        "eigh_desc_signed": (c,),
        "sign_columns": (y,),
        "svd_flip_signs": (rng.normal(size=(8, 6)), y.T),
        "sym_orthonormalize": (y,),
    }[name]
    ref = getattr(JA, name)(*(jnp.asarray(a) for a in args))
    got = getattr(TA, name)(*(torch.as_tensor(a) for a in args))
    if name == "eigh_desc_signed":   # vectors only where eigenvalues separate
        np.testing.assert_allclose(_np(got[0]), _np(ref[0]), rtol=1e-10,
                                   atol=1e-12 * float(ref[0][0]))
        ref, got = ref[1][:, :K], got[1][:, :K]
    for r, g in zip(ref if isinstance(ref, tuple) else (ref,),
                    got if isinstance(got, tuple) else (got,)):
        np.testing.assert_allclose(_np(g), _np(r), rtol=1e-10,
                                   atol=1e-10 * np.abs(_np(r)).max())


def _jax_omega(length, s):
    return np.array(jax.random.normal(jax.random.PRNGKey(7), (length, s),
                                      jnp.float64))


def test_pca_topk_cov_with_jax_omega():
    cals = _data()[0]
    s = K + 10
    omega = _jax_omega(cals.shape[2], s)
    cs = np.stack([_cov_of(x) for x in cals])
    got_w, got_v = TA.pca_topk_cov(torch.as_tensor(cs), s,
                                   omega=torch.as_tensor(omega))
    for c in range(cals.shape[0]):
        ref_w, ref_v = JA.pca_topk_cov(jnp.asarray(cs[c]), s)
        np.testing.assert_allclose(_np(got_w[c]), _np(ref_w), rtol=1e-8,
                                   atol=1e-8 * float(ref_w[0]))
        np.testing.assert_allclose(_np(got_v[c]), _np(ref_v), atol=1e-8)
        th_ref = JA.deflated_thetas(jnp.asarray(cs[c]), ref_w, ref_v, K)
        th_got = TA.deflated_thetas(torch.as_tensor(cs[c]), got_w[c],
                                    got_v[c], K)
        for g, r in zip(th_got, th_ref):
            np.testing.assert_allclose(g.item(), float(r), rtol=1e-8)


def test_pca_topk_cov_default_omega_is_seeded():
    c = torch.as_tensor(_cov_of(_data()[0][0]))
    w1, v1 = TA.pca_topk_cov(c, K + 10)
    w2, v2 = TA.pca_topk_cov(c, K + 10)
    assert torch.equal(w1, w2) and torch.equal(v1, v2)
    # the gapped leading eigenvalue agrees with the dense solver (the rest
    # sit in the noise bulk, where a random subspace tracks them to ~1e-3)
    dense = torch.linalg.eigvalsh(c).flip(-1)
    np.testing.assert_allclose(w1[0].item(), dense[0].item(), rtol=1e-8)


@functools.lru_cache(maxsize=None)
def _models(dtype):
    """Three JAX-fitted class models (means, loadings, invcovs) + x."""
    cals, xs = _data()
    models = jax.vmap(lambda x: jax_fit_simca(x, K))(
        jnp.asarray(cals, dtype))
    return (np.array(models.mean), np.array(models.components),
            np.array(models.invcovT), xs.astype(dtype))


def test_t2_q_scores_matches_jax():
    means, comps, invcovs, xs = _models(np.float64)
    ref = JA.t2_q_scores(jnp.asarray(xs), jnp.asarray(means[0]),
                         jnp.asarray(comps[0]), jnp.asarray(invcovs[0]))
    got = TA.t2_q_scores(torch.as_tensor(xs), torch.as_tensor(means[0]),
                         torch.as_tensor(comps[0]), torch.as_tensor(invcovs[0]))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(_np(g), _np(r), rtol=1e-9,
                                   atol=1e-12 * np.abs(_np(r)).max())


def test_plain_twin_matches_jax_multiclass():
    means, comps, invcovs, xs = _models(np.float64)
    t2_ref, q_ref, _ = JA.t2_q_scores_multiclass(
        jnp.asarray(xs), jnp.asarray(means), jnp.asarray(comps),
        jnp.asarray(invcovs))
    args = [torch.as_tensor(a) for a in (xs, means, comps, invcovs)]
    t2, q = t2q_scores_multiclass_plain(*args)
    assert t2.shape == q.shape == (3, xs.shape[0])
    np.testing.assert_allclose(_np(t2), _np(t2_ref), rtol=1e-9)
    np.testing.assert_allclose(_np(q), _np(q_ref), rtol=1e-9)
    # the wrapper takes the plain twin for CPU tensors
    t2w, qw = t2q_scores_multiclass(*args)
    assert torch.equal(t2w, t2) and torch.equal(qw, q)


@pytest.mark.parametrize("n_rows,tile_n", [(500, 128), (137, 64)])
def test_plain_twin_matches_pallas_interpret(n_rows, tile_n):
    """Float32 against the TPU kernel's own semantics, per class, as
    tests/test_kernels.py runs it (a ragged N included)."""
    means, comps, invcovs, xs = _models(np.float32)
    xs = xs[:n_rows]
    t2, q = t2q_scores_multiclass_plain(
        *(torch.as_tensor(a) for a in (xs, means, comps, invcovs)))
    assert t2.dtype == torch.float32
    for c in range(means.shape[0]):
        t2_k, q_k = t2_q_scores_pallas(
            jnp.asarray(xs), jnp.asarray(means[c]), jnp.asarray(comps[c]),
            jnp.asarray(invcovs[c]), tile_n=tile_n, interpret=True)
        assert t2_k.shape == (n_rows,)
        np.testing.assert_allclose(_np(t2[c]), _np(t2_k), rtol=2e-4)
        np.testing.assert_allclose(_np(q[c]), _np(q_k), rtol=2e-4, atol=1e-5)
