"""The port's CV-SIMCA (``ocm_tpu_torch.models.cv``) against
``ocm_tpu.models.cv``, float64 on the CPU: fold construction (sklearn's
order), the batched (class x fold x LV) sweep, its per-cell limits, the
multi-class sweep and the grid search with its refit.

Aggregates (spec, sens, eff) within 1e-10 relative; pooled predictions
and per-fold metrics equal; per-cell limits within 1e-8.  The target class
sits close to the other, so that every decision type rejects part of each
and the metrics move with the LV count.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocm_tpu.models import cv as JC
from ocm_tpu.models import simca as JS
from ocm_tpu_torch.models import cv as TC
from ocm_tpu_torch.models import simca as TS
from ocm_tpu_torch.stats import limits as TL
from oracles import make_class_spectra

LVS = [1, 2, 3, 5]


def _data(n0=70, n1=30, length=40, seed=11):
    rng = np.random.default_rng(seed)
    x = np.concatenate([make_class_spectra(rng, n0, length),
                        make_class_spectra(rng, n1, length, 0.005)])
    return x, np.repeat([0, 1], [n0, n1])


def _jax_omega(length, s):
    return np.array(jax.random.normal(jax.random.PRNGKey(7), (length, s),
                                      jnp.float64))


def _close(got, ref, rtol, what=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=rtol, atol=1e-12,
                               err_msg=what)


@pytest.mark.parametrize("n,k,shuffle,seed", [
    (10, 3, False, None), (11, 5, True, 0), (100, 7, True, 42),
    (5, 5, True, 3)])
def test_folds_match_jax(n, k, shuffle, seed):
    for a, b in zip(TC.kfold_slices(n, k, shuffle, seed),
                    JC.kfold_slices(n, k, shuffle, seed)):
        assert np.array_equal(a, b)
    y = np.random.default_rng(n).integers(0, 3, size=3 * n)
    y[:k] = 1
    for kw in (dict(cls_label=1), dict(cls_idx=1),
               dict(cls_idx=np.flatnonzero(y == 1))):
        ours = TC.ClasswiseKFoldWithExternalVal(k, shuffle=shuffle,
                                                random_state=seed, **kw)
        ref = JC.ClasswiseKFoldWithExternalVal(k, shuffle=shuffle,
                                               random_state=seed, **kw)
        assert ours.get_n_splits() == k
        for (tr, te), (tr_r, te_r) in zip(ours.split(y, y),
                                          ref.split(y, y), strict=True):
            assert np.array_equal(tr, tr_r) and np.array_equal(te, te_r)
    for a, b in zip(TC.fold_masks(y, 1, k, shuffle, seed),
                    JC.fold_masks(y, 1, k, shuffle, seed)):
        assert np.array_equal(a, b)


def test_folds_match_sklearn():
    from sklearn.model_selection import KFold

    for n, k, shuffle, seed in ((17, 4, False, None), (23, 5, True, 9)):
        ref = KFold(k, shuffle=shuffle, random_state=seed).split(np.zeros(n))
        for fold, (_, test) in zip(TC.kfold_slices(n, k, shuffle, seed), ref,
                                   strict=True):
            assert np.array_equal(np.sort(fold), test)


def test_parameter_grid_and_validation():
    grid = {"type": ["alt", "sim"], "qlim": ["jm", "perc"], "a": [1]}
    assert list(TC.parameter_grid(grid)) == list(JC.parameter_grid(grid))
    assert list(TC.parameter_grid({})) == [{}]
    with pytest.raises(ValueError, match="at least 2"):
        TC.kfold_slices(5, 1)
    with pytest.raises(ValueError, match="cannot split"):
        TC.kfold_slices(3, 4)
    with pytest.raises(ValueError, match="splits >"):
        list(TC.ClasswiseKFoldWithExternalVal(9, cls_label=1).split(
            np.zeros(20), np.repeat([0, 1], [12, 8])))
    x, y = _data()
    with pytest.raises(ValueError, match="unknown solver"):
        TC.cv_simca_sweep(x, y, 0, LVS, solver="svd", device="cpu")


# (solver, side, decision, T2 method, Q method, shuffle): every decision
# type, both eigh sides, the randomized sweep, a shuffled split
SWEEPS = [("eigh", "cov", "alt", "Fdist", "jm", False),
          ("eigh", "gram", "sim", "perc", "perc", False),
          ("rsvd", "auto", "ci", "chi2", "chi2box", True),
          ("eigh", "auto", "dd", "Fdist", "jm", False),
          ("rsvd", "auto", "alt", "Fdistrig", "chi2pom", False)]


def _sweep_kw(case):
    solver, side, decision, t2, q, shuffle = case
    return dict(solver=solver, side=side, decision_type=decision,
                t2_method=t2, q_method=q, shuffle=shuffle,
                random_state=7 if shuffle else None, n_splits=5)


@pytest.mark.parametrize("case", SWEEPS, ids=["-".join(map(str, c[:5]))
                                             for c in SWEEPS])
def test_sweep_matches_jax(case):
    x, y = _data()
    kw = _sweep_kw(case)
    ref = JC.cv_simca_sweep(x, y, 0, LVS, **kw)
    omega = torch.as_tensor(_jax_omega(x.shape[1], max(LVS) + 10))
    ours = TC.cv_simca_sweep(x, y, 0, LVS, device="cpu", omega=omega, **kw)
    assert sorted(ours) == sorted(ref)
    for key in ("spec", "sens", "eff"):
        _close(ours[key], ref[key], 1e-10, key)
    for key in ("pred", "fold_sens", "fold_spec"):
        assert np.array_equal(ours[key], ref[key]), key
    assert 0 < ref["spec"].min() < 100 and ref["sens"].min() < 100
    # on the device, unconverted: the same values as tensors
    dev = TC.cv_simca_sweep(torch.as_tensor(x), y, 0, LVS, omega=omega,
                            convert=False, **kw)
    assert isinstance(dev["eff"], torch.Tensor)
    assert torch.equal(dev["pred"], torch.as_tensor(ours["pred"]))


def test_sweep_on_the_gram_side_by_shape():
    """Fewer rows than channels: 'auto' decomposes the Gram matrix, as the
    reference does, and agrees with it."""
    x, y = _data(n0=40, n1=20, length=64)
    ref = JC.cv_simca_sweep(x, y, 0, [2, 4])
    ours = TC.cv_simca_sweep(x, y, 0, [2, 4], device="cpu")
    for key in ("spec", "sens", "eff"):
        _close(ours[key], ref[key], 1e-10, key)
    assert np.array_equal(ours["pred"], ref["pred"])


@pytest.mark.parametrize("solver", ["eigh", "rsvd"])
def test_sweep_cell_limits_match_jax(solver):
    """The (fold, LV) cells' T^2, Q and critical limits (first and last
    fold, every LV), as the reference's helpers give them a cell at a
    time."""
    x, y = _data()
    train, held = TC.fold_masks(y, 0, 5)
    n_sub = max(LVS) + 10
    omega = _jax_omega(x.shape[1], n_sub)
    lvs = torch.as_tensor(LVS)
    sweep = TC.fold_lv_sweep(
        torch.as_tensor(x), torch.as_tensor(train), torch.as_tensor(held),
        torch.as_tensor(y != 0)[None], lvs, solver=solver, n_sub=n_sub,
        subspace_iters=4, decision_type="ci", t2_method="Fdist",
        q_method="jm", t2_cl=0.95, q_cl=0.95, d_cl=0.95,
        omega=torch.as_tensor(omega))
    for f in (0, 4):
        pca, thetas_of = JC.fold_decomposition(
            jnp.asarray(x), jnp.asarray(train[f]), solver, n_sub, 4)
        w = jnp.asarray(train[f], jnp.float64)
        xc = jnp.asarray(x) - pca.mean[None, :]
        t_all = xc @ pca.eigvec
        xc2 = jnp.sum(xc * xc, axis=1)
        for j, k in enumerate(LVS):
            t2, q = JC.lv_t2_q(pca.eigenvalues, t_all * w[:, None], xc2 * w,
                               k)
            t2_res, q_res, d_lim = JC.lv_limits(
                t2, q, w, pca.n, k, thetas_of(k), "ci", "Fdist", "jm",
                0.95, 0.95, 0.95)
            _close(sweep.t2_res.limit[f, j], t2_res.limit, 1e-8, "t2")
            _close(sweep.q_res.limit[f, j], q_res.limit, 1e-8, "q")
            _close(sweep.d_limit[f, j], d_lim, 1e-8, "d")
    if solver == "rsvd":
        # the tables give every cut's moments as the deflation does
        _, thetas_of = TC.fold_decomposition(
            torch.as_tensor(x), torch.as_tensor(train[:1]), "rsvd", n_sub,
            4, omega=torch.as_tensor(omega))
        ours = thetas_of(lvs)
        for j, k in enumerate(LVS):
            ref = JC.fold_decomposition(jnp.asarray(x), jnp.asarray(train[0]),
                                        "rsvd", n_sub, 4)[1](k)
            for a, b in zip(ours, ref):
                _close(a[0, j], b, 1e-9, f"theta k={k}")


def test_multiclass_sweep_matches_jax_and_single_class():
    x, y = _data()
    y = y.copy()
    y[::7] = 2                                   # three classes
    ref = JC.cv_simca_sweep_multiclass(x, y, [0, 1, 2], LVS, n_splits=4)
    ours = TC.cv_simca_sweep_multiclass(x, y, [0, 1, 2], LVS, n_splits=4,
                                        device="cpu")
    assert sorted(ours) == sorted(ref) == ["eff", "pred", "sens", "spec"]
    for key in ("spec", "sens", "eff"):
        _close(ours[key], ref[key], 1e-10, key)
    assert np.array_equal(ours["pred"], ref["pred"])
    one = TC.cv_simca_sweep(x, y, 2, LVS, n_splits=4, device="cpu")
    for key in ("spec", "sens", "eff", "pred"):
        assert np.array_equal(ours[key][2], one[key]), key


def test_sweep_runs_each_limit_engine_once(monkeypatch):
    """A sweep of 5 folds x 4 LVs evaluates each limit engine once, on
    tensors of every cell, not once a cell (the eager quantile loops cost
    the same whatever the batch)."""
    calls = {"f_ppf": 0, "chi2_ppf": 0, "jm_limit": 0}

    def counted(name, fn):
        def wrapper(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapper

    monkeypatch.setattr(TL, "f_ppf", counted("f_ppf", TL.f_ppf))
    monkeypatch.setattr(TL, "jm_limit", counted("jm_limit", TL.jm_limit))
    monkeypatch.setattr(TL, "chi2_ppf", counted("chi2_ppf", TL.chi2_ppf))
    monkeypatch.setattr(TS, "chi2_ppf", counted("chi2_ppf", TS.chi2_ppf))
    x, y = _data()
    TC.cv_simca_sweep(x, y, 0, LVS, device="cpu")
    assert calls == {"f_ppf": 1, "chi2_ppf": 0, "jm_limit": 1}
    TC.cv_simca_sweep_multiclass(x, y, [0, 1], LVS, device="cpu",
                                 decision_type="ci")
    assert calls == {"f_ppf": 2, "chi2_ppf": 1, "jm_limit": 2}
    # 'dd': the T^2 and Q moment fits and the critical distance
    TC.cv_simca_sweep(x, y, 0, LVS, device="cpu", solver="rsvd",
                      decision_type="dd")
    assert calls == {"f_ppf": 2, "chi2_ppf": 4, "jm_limit": 2}


@pytest.mark.parametrize("grid", [{"type": ["alt", "sim"]},
                                  {"n_components": [2, 4]}],
                         ids=["type", "n_components"])
def test_grid_matches_jax(grid, capsys):
    x, y = _data()
    cv_ref = JC.ClasswiseKFoldWithExternalVal(4, cls_label=0, shuffle=True,
                                              random_state=1)
    cv = TC.ClasswiseKFoldWithExternalVal(4, cls_label=0, shuffle=True,
                                          random_state=1)
    kw = dict(LV_min=1, LV_max=4, param_grid=grid, store_predictions=True)
    ref = JC.cross_validate_simca_grid(
        JS.SIMCA(model_class=0, verbose=False), x, y, cv_ref, **kw)
    printed_ref = capsys.readouterr().out
    ours = TC.cross_validate_simca_grid(
        TS.SIMCA(model_class=0, verbose=False, device="cpu"), x, y, cv, **kw)
    assert capsys.readouterr().out == printed_ref
    assert len(ours["results"]) == len(ref["results"])
    for a, b in zip(ours["results"], ref["results"]):
        assert a["params"] == b["params"] and a["LV"] == b["LV"]
        for key in ("spec", "sens", "eff"):
            _close(a[key], b[key], 1e-10, key)
    for a, b in zip(ours["by_combo"], ref["by_combo"]):
        assert np.array_equal(a["prediction"], b["prediction"])
    for key in ("best_params", "best_LV"):
        assert ours[key] == ref[key]
    _close(ours["best_score"], ref["best_score"], 1e-10)
    best, best_ref = ours["best_estimator"], ref["best_estimator"]
    assert best.get_params()["device"] == "cpu"
    assert best.n_components == best_ref.n_components
    assert np.array_equal(best.predict(x), best_ref.predict(x))
