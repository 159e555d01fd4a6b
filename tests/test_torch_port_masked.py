"""The port's masked SIMCA fit (``fit_simca_masked``, ``masked_pca_eig``,
the masked limit engines) and ``fit_classes`` for classes of unequal size
against ``ocm_tpu``, float64 on the CPU.

Statistics that do not depend on the basis inside a degenerate eigenvalue
cluster are compared (T^2, Q, thetas, limits, the critical distance,
decisions), at 1e-8 relative; loadings only above the top-k gap.  The
randomized solver replays the JAX package's test matrix (``omega``).
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocm_tpu.models import simca as JS
from ocm_tpu.stats import limits as JL
from ocm_tpu_torch.models import simca as TS
from ocm_tpu_torch.stats import limits as TL
from oracles import make_class_spectra

RTOL = 1e-8
T2_METHODS = ["perc", "Fdistrig", "Fdist", "chi2", "chi2pom"]
Q_METHODS = ["perc", "jm", "chi2box", "chi2pom"]
DECISIONS = ["alt", "sim", "ci", "dd"]
# (solver, rows): N >= L decomposes the covariance, N < L the sample Gram
SOLVERS = [("eigh", 72), ("eigh", 36), ("rsvd", 72)]
LENGTH, K = 48, 5
GRID = [(t2, q, DECISIONS[i % 4], *SOLVERS[i % 3])
        for i, (t2, q) in enumerate(itertools.product(T2_METHODS, Q_METHODS))]


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _close(got, ref, what="", rtol=RTOL):
    ref = _np(ref)
    np.testing.assert_allclose(_np(got), ref, rtol=rtol,
                               atol=1e-12 * max(np.abs(ref).max(), 1e-300),
                               err_msg=what)


def _jax_omega(length, s):
    return np.array(jax.random.normal(jax.random.PRNGKey(7), (length, s),
                                      jnp.float64))


def _masked_data(rows, seed=0):
    """Spectra of one class with the last fifth of the rows masked out."""
    rng = np.random.default_rng(seed)
    x = make_class_spectra(rng, rows, LENGTH)
    w = np.ones(rows)
    w[-rows // 5:] = 0.0
    return x, w


def _assert_models_close(port, ref, what=""):
    for field in ("t2_train", "q_train", "d_limit", "mean"):
        _close(getattr(port, field), getattr(ref, field), f"{what} {field}")
    for res in ("t2_res", "q_res"):
        for field in ("limit", "dof", "scale"):
            _close(getattr(getattr(port, res), field),
                   getattr(getattr(ref, res), field), f"{what} {res}.{field}")
    assert np.array_equal(_np(port.n_samples), np.asarray(ref.n_samples))


def _ids(case):
    t2, q, d, solver, rows = case
    return f"{t2}-{q}-{d}-{solver}-{'cov' if rows >= LENGTH else 'gram'}"


@pytest.mark.parametrize("case", GRID, ids=_ids)
def test_masked_fit_matches_jax(case):
    t2, q, decision, solver, rows = case
    x, w = _masked_data(rows)
    kw = dict(decision_type=decision, t2_method=t2, q_method=q,
              solver=solver)
    ref = JS.fit_simca_masked(jnp.asarray(x), jnp.asarray(w), K, **kw)
    port = TS.fit_simca_masked(
        x, w, K, device="cpu",
        omega=torch.as_tensor(_jax_omega(LENGTH, K + 10)), **kw)
    _assert_models_close(port, ref, _ids(case))
    # decisions on fresh spectra, some off the class
    rng = np.random.default_rng(1)
    x_new = np.concatenate([make_class_spectra(rng, 30, LENGTH),
                            make_class_spectra(rng, 30, LENGTH, 0.01)])
    acc, dred = TS.simca_decide(port, x_new, decision)[:2]
    acc_ref, dred_ref = JS.simca_decide(ref, jnp.asarray(x_new), decision)[:2]
    _close(dred, dred_ref, "dred")
    assert np.array_equal(_np(acc), np.asarray(acc_ref))


@pytest.mark.parametrize("rows", [72, 36], ids=["cov", "gram"])
def test_masked_thetas_match_jax(rows):
    """The residual moments each solver feeds the limits: full-spectrum
    sums masked at the effective rank (eigh), covariance deflation
    (rsvd)."""
    x, w = _masked_data(rows)
    jp = JS.masked_pca_eig(jnp.asarray(x), jnp.asarray(w))
    tp = TS.masked_pca_eig(torch.as_tensor(x), torch.as_tensor(w))
    r = int(w.sum()) - 1                      # the centered rank
    _close(tp.eigenvalues[:r], jp.eigenvalues[:r], "eigenvalues")
    for k in (1, K, 12):
        for a, b in zip(TL.residual_thetas(tp.eigenvalues, k, tp.max_rank),
                        JL.residual_thetas(jp.eigenvalues, k, jp.max_rank)):
            _close(a, b, f"theta k={k}")


@pytest.mark.parametrize("side", ["cov", "gram"])
def test_masked_pca_sides_match_jax_and_numpy(side):
    x, w = _masked_data(48)
    jp = JS.masked_pca_eig(jnp.asarray(x), jnp.asarray(w), side=side)
    tp = TS.masked_pca_eig(torch.as_tensor(x), torch.as_tensor(w), side=side)
    assert tuple(tp.eigvec.shape) == tuple(jp.eigvec.shape)
    assert int(tp.max_rank) == int(jp.max_rank) and float(tp.n) == w.sum()
    _close(tp.mean, jp.mean, "mean")
    # loadings above the gap, sign-fixed, against JAX and a numpy SVD of
    # the masked centered rows
    rows = x[w > 0]
    _, s, vt = np.linalg.svd(rows - rows.mean(0), full_matrices=False)
    flip = np.sign(vt[np.arange(8), np.abs(vt[:8]).argmax(1)])
    _close(tp.eigvec[:, :8], jp.eigvec[:, :8], "loadings", rtol=1e-7)
    _close(tp.eigvec[:, :8].T, vt[:8] * flip[:, None], "vs numpy", rtol=1e-7)
    r = rows.shape[0] - 1
    _close(tp.eigenvalues[:r], (s * s / r)[:r], "spectrum vs numpy")


def test_gram_side_degenerate_rows_match_jax():
    """Duplicated rows and constant channels: the Gram side's roundoff
    columns are zeroed (no junk column injects lambda_max into Q), and the
    fit at k near the rank equals the reference's."""
    rng = np.random.default_rng(2)
    base = make_class_spectra(rng, 20, 80)
    x = np.concatenate([base, base[:12]])          # 32 rows, rank <= 19
    x[:, 40] = 1.0
    x[:, 41] = 1.0
    w = np.ones(32)
    tp = TS.masked_pca_eig(torch.as_tensor(x), torch.as_tensor(w),
                           side="gram")
    norms = torch.linalg.vector_norm(tp.eigvec, dim=0)
    assert bool((norms <= 1.0 + 1e-8).all())
    assert bool((norms[21:] == 0.0).all())
    jm = JS.fit_simca_masked(jnp.asarray(x), jnp.asarray(w), 15)
    tm = TS.fit_simca_masked(x, w, 15, device="cpu")
    _assert_models_close(tm, jm, "degenerate")
    x_new = make_class_spectra(rng, 40, 80, center_shift=0.5)
    x_new[:, 40:42] = 1.0
    _close(TS.simca_decide(tm, x_new)[1],
           JS.simca_decide(jm, jnp.asarray(x_new))[1], "dred")


def test_masked_percentile_and_moments():
    """Batched over (2, 3) rows of different counts: the masked
    percentile equals ``np.percentile`` of the kept entries and the JAX
    function; the moments are the kept entries' mean and ddof-1 var."""
    rng = np.random.default_rng(4)
    v = rng.gamma(2.0, size=(2, 3, 17))
    w = (rng.uniform(size=(2, 3, 17)) < 0.7).astype(float)
    w[..., :3] = 1.0
    n = w.sum(-1)
    for cl in (0.0, 0.5, 0.95, 1.0):
        got = TS.masked_percentile(torch.as_tensor(v), torch.as_tensor(w),
                                   torch.as_tensor(n), cl)
        for i, j in np.ndindex(2, 3):
            kept = v[i, j][w[i, j] > 0]
            ref = JS.masked_percentile(jnp.asarray(v[i, j]),
                                       jnp.asarray(w[i, j]),
                                       jnp.asarray(n[i, j]), cl)
            _close(got[i, j], ref, f"cl={cl}")
            _close(got[i, j], np.percentile(kept, 100 * cl), "numpy")
    m, var = TS.masked_moments(torch.as_tensor(v), torch.as_tensor(w),
                               torch.as_tensor(n))
    for i, j in np.ndindex(2, 3):
        kept = v[i, j][w[i, j] > 0]
        _close(m[i, j], kept.mean())
        _close(var[i, j], kept.var(ddof=1))


def test_masked_fit_batches_over_leading_axes():
    """A (2, 2) batch of masked fits equals the fits one at a time."""
    rng = np.random.default_rng(5)
    x = make_class_spectra(rng, 60, LENGTH)
    w = (rng.uniform(size=(2, 2, 60)) < 0.8).astype(float)
    omega = torch.as_tensor(_jax_omega(LENGTH, K + 10))
    kw = dict(t2_method="chi2", q_method="perc", decision_type="ci",
              device="cpu", omega=omega)
    for solver in ("eigh", "rsvd"):
        batch = TS.fit_simca_masked(x, w, K, solver=solver, **kw)
        for i, j in np.ndindex(2, 2):
            one = TS.fit_simca_masked(x, w[i, j], K, solver=solver, **kw)
            for a, b in zip(TS.simca_model_to_numpy(one).values(),
                            TS.simca_model_to_numpy(batch).values()):
                if isinstance(a, dict):
                    for key in a:
                        _close(a[key], b[key][i, j], key, rtol=1e-10)
                elif a.ndim and a.shape[-2:] == (K, LENGTH):
                    # loadings up to sign is fixed; compare the projector
                    _close(a.T @ a, b[i, j].T @ b[i, j], "P", rtol=1e-9)
                elif a.ndim == 0 or a.shape[0] != K:
                    _close(a, b[i, j], rtol=1e-10)


def _unequal_classes(seed=3, counts=(70, 52, 34), length=LENGTH):
    rng = np.random.default_rng(seed)
    x = np.concatenate([make_class_spectra(rng, n, length, center_shift=s)
                        for n, s in zip(counts, (0.0, 0.4, 0.9))])
    y = np.repeat([5, 6, 7], counts)
    order = rng.permutation(len(y))
    return x[order], y[order]


@pytest.mark.parametrize("solver", ["eigh", "rsvd"])
def test_fit_classes_unequal_matches_jax(solver):
    x, y = _unequal_classes()
    kw = dict(solver=solver, decision_type="ci", q_method="chi2box")
    ref = JS.fit_classes(jnp.asarray(x), y, [5, 6, 7], K, **kw)
    port = TS.fit_classes(x, y, [5, 6, 7], K, device="cpu",
                          omega=torch.as_tensor(_jax_omega(LENGTH, K + 10)),
                          **kw)
    _assert_models_close(port, ref, solver)
    assert port.t2_train.shape == (3, 70)
    assert _np(port.n_samples).tolist() == [70, 52, 34]
    acc = TS.predict_classes(port, x, "ci")
    acc_ref = JS.predict_classes(ref, jnp.asarray(x), "ci")
    _close(acc[1], acc_ref[1], "dred")
    assert np.array_equal(_np(acc[0]), np.asarray(acc_ref[0]))


def test_fit_classes_unequal_side_follows_padded_shape():
    """Padded rows fewer than the channels: the Gram side, as in the
    reference."""
    x, y = _unequal_classes(counts=(40, 31, 22), length=64)
    ref = JS.fit_classes(jnp.asarray(x), y, [5, 6, 7], 6)
    port = TS.fit_classes(x, y, [5, 6, 7], 6, device="cpu")
    assert port.eigenvalues.shape == (3, 40)
    _assert_models_close(port, ref, "gram")


def test_fit_classes_unequal_rejects_svd_in_both():
    """``fit_simca_masked`` takes 'eigh' or 'rsvd': the reference's
    ``fit_classes(..., solver='svd')`` raises for unequal sizes, and so
    does the port's."""
    x, y = _unequal_classes()
    with pytest.raises(ValueError, match="unknown solver 'svd'"):
        JS.fit_classes(jnp.asarray(x), y, [5, 6, 7], K, solver="svd")
    with pytest.raises(ValueError, match="unknown solver 'svd'"):
        TS.fit_classes(x, y, [5, 6, 7], K, solver="svd", device="cpu")
    with pytest.raises(ValueError, match="count=34"):
        TS.fit_classes(x, y, [5, 6, 7], 40, device="cpu")


def test_masked_fit_with_all_rows_equals_fit_simca():
    """Masks all on: the masked fit is the dense one (eigh against svd)."""
    rng = np.random.default_rng(6)
    x = np.stack([make_class_spectra(rng, 60, LENGTH, s) for s in (0, .5)])
    dense = TS.fit_simca(x, K, device="cpu")
    masked = TS.fit_simca_masked(x, np.ones((2, 60)), K, device="cpu")
    _assert_models_close(masked, dense._replace(
        n_samples=dense.n_samples.numpy()), "all rows")


def test_masked_fit_validation():
    x, w = _masked_data(40)
    with pytest.raises(ValueError, match="n_components"):
        TS.fit_simca_masked(x, w, 41, device="cpu")
    with pytest.raises(ValueError, match="unknown side"):
        TS.masked_pca_eig(torch.as_tensor(x), torch.as_tensor(w), side="x")
    with pytest.raises(ValueError, match="unknown t2 limit"):
        TS.fit_simca_masked(x, w, 3, t2_method="bogus", device="cpu")
