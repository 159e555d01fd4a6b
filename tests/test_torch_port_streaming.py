"""The port's streaming SIMCA (``ocm_tpu_torch.models.streaming``) against
``ocm_tpu.models.streaming``, float64 on the CPU.

The statistic (count, mean, centered scatter) must equal JAX's to 1e-12
however the stream is batched, masked or merged; the moments fits must
equal JAX's for every field, with ``eigh`` and with ``rsvd`` given JAX's
test matrix (the ``PRNGKey(7)`` draw its ``pca_topk_cov`` makes).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocm_tpu.models import streaming as JM
from ocm_tpu_torch.models import simca as TS
from ocm_tpu_torch.models import streaming as TM
from torch_port_data import K, LENGTH, make_data

RTOL = 1e-12


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _close(got, ref, rtol=RTOL, what=""):
    ref = _np(ref)
    np.testing.assert_allclose(_np(got), ref, rtol=rtol,
                               atol=rtol * max(np.abs(ref).max(), 1e-300),
                               err_msg=what)


def _same_moments(got, ref, rtol=RTOL):
    for f in ("n", "mean", "scatter"):
        _close(getattr(got, f), getattr(ref, f), rtol, what=f)


def _stream():
    cals, _ = make_data(seed=6)
    x = cals.reshape(-1, LENGTH) + 100.0          # a large common mode
    y = np.repeat(np.arange(3), cals.shape[1])
    order = np.random.default_rng(6).permutation(len(y))
    return x[order], y[order]


def _jax_omega():
    return np.array(jax.random.normal(jax.random.PRNGKey(7), (LENGTH, K + 10),
                                      jnp.float64))


def test_batched_update_and_merge_match_jax():
    x, _ = _stream()
    mom = TM.moments_init(LENGTH, torch.float64, device="cpu")
    ref = JM.moments_init(LENGTH, jnp.float64)
    for lo in range(0, len(x), 37):                # ragged batches
        mom = TM.moments_update(mom, x[lo:lo + 37])
        ref = JM.moments_update(ref, x[lo:lo + 37])
    _same_moments(mom, ref)
    np.testing.assert_allclose(TM.moments_cov(mom).numpy(),
                               np.cov(x, rowvar=False), rtol=1e-9, atol=1e-12)
    _close(TM.moments_std(mom), JM.moments_std(ref))
    parts = [TM.moments_from(x[a:b], device="cpu")
             for a, b in ((0, 100), (100, 250), (250, None))]
    merged = TM.moments_merge(parts[2], TM.moments_merge(parts[1], parts[0]))
    _same_moments(merged, ref, rtol=1e-10)
    empty = TM.moments_init(LENGTH, torch.float64, device="cpu")
    same = TM.moments_merge(empty, merged)
    assert torch.equal(same.scatter, merged.scatter)
    assert TM.moments_update(merged, x[:0]) is merged


def test_masked_and_weighted_updates_match_jax():
    x, _ = _stream()
    x = x[:80]
    rng = np.random.default_rng(1)
    for w in ((rng.random(80) < 0.6).astype(np.float64),
              rng.integers(0, 4, 80).astype(np.float64)):
        mom = TM.moments_update(TM.moments_init(LENGTH, torch.float64, "cpu"),
                                x, w=w)
        ref = JM.moments_update(JM.moments_init(LENGTH, jnp.float64), x, w=w)
        _same_moments(mom, ref)
    # an all-zero mask is an exact no-op
    zero = TM.moments_update(mom, x, w=np.zeros(80))
    assert torch.equal(zero.scatter, mom.scatter)
    assert torch.equal(zero.mean, mom.mean) and zero.n == mom.n


def test_class_ingest_matches_jax():
    x, y = _stream()
    y = np.where(np.arange(len(y)) % 17 == 0, 9, y)     # unlabelled rows
    moms = TM.moments_init_classes(3, LENGTH, torch.float64, device="cpu")
    ref = JM.moments_init_classes(3, LENGTH, jnp.float64)
    for lo in range(0, len(x), 50):
        moms = TM.moments_update_classes(moms, x[lo:lo + 50], y[lo:lo + 50],
                                         [0, 1, 2])
        ref = JM.moments_update_classes(ref, x[lo:lo + 50], y[lo:lo + 50],
                                        [0, 1, 2])
    assert moms.scatter.shape == (3, LENGTH, LENGTH)
    _same_moments(moms, ref)
    for c in range(3):
        kept = x[y == c]
        assert moms.n[c].item() == len(kept)
        np.testing.assert_allclose(TM.moments_cov(moms)[c].numpy(),
                                   np.cov(kept, rowvar=False), rtol=1e-9,
                                   atol=1e-12)


def _class_moments():
    x, y = _stream()
    moms = TM.moments_init_classes(3, LENGTH, torch.float64, device="cpu")
    ref = JM.moments_init_classes(3, LENGTH, jnp.float64)
    for lo in range(0, len(x), 90):
        moms = TM.moments_update_classes(moms, x[lo:lo + 90], y[lo:lo + 90],
                                         [0, 1, 2])
        ref = JM.moments_update_classes(ref, x[lo:lo + 90], y[lo:lo + 90],
                                        [0, 1, 2])
    return x, y, moms, ref


FITS = [("eigh", "alt", "Fdist", "jm"), ("rsvd", "alt", "Fdist", "jm"),
        ("eigh", "sim", "chi2", "chi2box"), ("rsvd", "ci", "Fdistrig", "jm")]


@pytest.mark.parametrize("case", FITS, ids=["-".join(c) for c in FITS])
def test_fit_classes_moments_matches_jax(case):
    solver, decision_type, t2_method, q_method = case
    _, _, moms, ref_moms = _class_moments()
    kw = dict(decision_type=decision_type, t2_method=t2_method,
              q_method=q_method, solver=solver)
    got = TM.fit_classes_moments(
        moms, K, **kw,
        omega=torch.as_tensor(_jax_omega()) if solver == "rsvd" else None)
    ref = JM.fit_classes_moments(ref_moms, K, **kw)
    for f in ("mean", "eigenvalues", "invcovT", "d_limit"):
        _close(getattr(got, f), getattr(ref, f), rtol=1e-8, what=f)
    for res in ("t2_res", "q_res"):
        for f in ("limit", "dof", "scale"):
            _close(getattr(getattr(got, res), f),
                   getattr(getattr(ref, res), f), rtol=1e-8,
                   what=f"{res}.{f}")
    proj = lambda p: _np(p).transpose(0, 2, 1) @ _np(p)
    _close(proj(got.components), proj(ref.components), rtol=1e-6,
           what="projector")
    assert got.t2_train.shape == (3, 0) and got.n_samples.tolist() == [120] * 3


def test_single_fit_and_decisions_match_fit_simca():
    """The moments fit of one class reproduces ``fit_simca`` of the same
    spectra (the limits and decisions the scorer uses)."""
    x, y, moms, ref_moms = _class_moments()
    one = TM.fit_simca_moments(TM.moments_from(x[y == 1], device="cpu"), K)
    ref = JM.fit_simca_moments(JM.moments_from(jnp.asarray(x[y == 1])), K)
    _close(one.d_limit, ref.d_limit, rtol=1e-8)
    _close(one.q_res.limit, ref.q_res.limit, rtol=1e-8)
    full = TS.fit_simca(x[y == 1], K, solver="svd", device="cpu")
    _close(one.q_res.limit, full.q_res.limit, rtol=1e-8)
    _close(one.t2_res.limit, full.t2_res.limit, rtol=1e-8)
    xs = make_data(seed=6)[1] + 100.0
    acc, dred = TS.simca_decide(one, xs)[:2]
    acc_f, dred_f = TS.simca_decide(full, xs)[:2]
    assert torch.equal(acc, acc_f)
    _close(dred, dred_f, rtol=1e-7)


def test_moment_fit_validation(tmp_path):
    _, _, moms, _ = _class_moments()
    with pytest.raises(ValueError, match="per-sample training T"):
        TM.fit_classes_moments(moms, K, t2_method="perc")
    with pytest.raises(ValueError, match="per-sample training Q"):
        TM.fit_classes_moments(moms, K, q_method="chi2pom")
    with pytest.raises(ValueError, match="moment matching"):
        TM.fit_classes_moments(moms, K, decision_type="dd")
    with pytest.raises(ValueError, match="unknown solver"):
        TM.fit_classes_moments(moms, K, solver="svd")
    with pytest.raises(ValueError, match="class axis"):
        TM.fit_classes_moments(TM.SpectraMoments(*(a[0] for a in moms)), K)
    path = tmp_path / "moments.msgpack"
    TM.save_moments(path, moms)
    with pytest.raises(ValueError, match="expected L=7"):
        TM.load_moments(path, length=7)
