"""The port's outlier removal and object-aware splits
(``ocm_tpu_torch.utils.outliers``, ``utils.splits``) against
``ocm_tpu``'s, on the CPU.

- ``mahalanobis_outlier_mask`` in f64: distances and threshold within
  1e-10 relative and keep masks equal, for both solvers (rsvd with the
  JAX package's own test matrix) and ``squared`` on and off;
- ``shuffle_split`` equal to sklearn's ``train_test_split``;
- ``object_aware_splits``: every array bit-equal to the JAX package's on
  ``tests/test_data.py``'s cases (f32 spectra, so both packages run the
  outlier step in f32), NaN rows, two and one objects, dict entries, and
  the same error for fractions that do not sum to 1.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocm_tpu.utils import outliers as JO
from ocm_tpu.utils import splits as JS
from ocm_tpu_torch.utils import outliers as TO
from ocm_tpu_torch.utils import splits as TS
from oracles import make_class_spectra


@pytest.fixture(scope="module")
def planted():
    """300 spectra of 12 latent factors of falling variance (the top 8 set
    apart from the rest, so that the randomized solver's subspace is
    determined to roundoff, not a rotation inside a noise bulk) with three
    gross outliers planted."""
    rng = np.random.default_rng(42)
    scales = np.array([10, 8, 6, 5, 4, 3, 2.5, 2, 1.2, 1, 0.8, 0.6])
    loadings = np.linalg.qr(rng.normal(size=(70, 12)))[0].T
    x = (make_class_spectra(rng, 300, 70)
         + (rng.normal(size=(300, 12)) * scales) @ loadings)
    for i, scale in zip((3, 40, 222), (30.0, -25.0, 40.0)):
        x[i] += scale * loadings[0] + scale * loadings[5]
    return x


@pytest.mark.parametrize("squared", [False, True])
@pytest.mark.parametrize("solver", ["svd", "rsvd"])
def test_outlier_mask_matches_jax(planted, solver, squared):
    k = 8
    ref = JO.mahalanobis_outlier_mask(jnp.asarray(planted), k,
                                      squared=squared, solver=solver)
    omega = None
    if solver == "rsvd":
        s_sub = min(k + 10, planted.shape[1], planted.shape[0] - 1)
        omega = torch.as_tensor(np.array(jax.random.normal(
            jax.random.PRNGKey(7), (planted.shape[1], s_sub), jnp.float64)))
    keep, dist, thr = TO.mahalanobis_outlier_mask(
        planted, k, squared=squared, solver=solver, device="cpu",
        omega=omega)
    assert keep.dtype == torch.bool and dist.dtype == torch.float64
    np.testing.assert_array_equal(keep.numpy(), np.asarray(ref[0]))
    np.testing.assert_allclose(dist.numpy(), np.asarray(ref[1]), rtol=1e-10)
    np.testing.assert_allclose(float(thr), float(ref[2]), rtol=1e-10)
    assert not keep[[3, 40, 222]].any()
    assert abs(keep.double().mean().item() - 0.95) < 0.01


def test_outlier_percentiles_and_errors(planted):
    for p in (50.0, 90.0, 99.0):
        keep, dist, thr = TO.mahalanobis_outlier_mask(
            planted, 5, percentile=p, device="cpu")
        _, _, ref_thr = JO.mahalanobis_outlier_mask(jnp.asarray(planted), 5,
                                                    percentile=p)
        np.testing.assert_allclose(float(thr), float(ref_thr), rtol=1e-10)
        assert bool((keep == (dist <= thr)).all())
    with pytest.raises(ValueError, match="solver"):
        TO.mahalanobis_outlier_mask(planted, 8, solver="qr", device="cpu")
    for n, f in ((100, 50), (5, 50), (100, 3), (1, 50)):
        assert TO.effective_n_components(n, f) == \
            JO.effective_n_components(n, f)


@pytest.mark.parametrize("n", [1, 2, 7, 20, 1001])
def test_percentile_of_matches_numpy(n):
    v = np.random.default_rng(n).normal(size=n)
    for q in (0.0, 5.0, 50.0, 95.0, 99.9, 100.0):
        np.testing.assert_allclose(
            float(TO.percentile_of(torch.as_tensor(v), q)),
            np.percentile(v, q), rtol=1e-14, atol=1e-15)


@pytest.mark.parametrize("n,test_size,seed", [
    (10, 0.3, 42), (7, 0.15, 42), (23, 0.5, 0), (3, 0.34, 7), (40, 0.15, 5)])
def test_shuffle_split_matches_sklearn(n, test_size, seed):
    from sklearn.model_selection import train_test_split

    items = list(range(100, 100 + n))
    tr_sk, te_sk = train_test_split(items, test_size=test_size,
                                    random_state=seed)
    assert TS.shuffle_split(items, test_size, seed) == (list(tr_sk),
                                                        list(te_sk))
    assert TS.shuffle_split(items, test_size, seed) == \
        JS.shuffle_split(items, test_size, seed)
    with pytest.raises(ValueError):
        TS.shuffle_split([1], 0.5, 0)


def _objects(rng, n_objects, pixels, length, shift=0.0):
    t = np.linspace(0, 1, length)
    base = np.sin(2 * np.pi * (3 + shift) * t)
    out = []
    for _ in range(n_objects):
        amp = rng.normal(1, 0.05, (pixels, 1))
        out.append((amp * base + rng.normal(0, 0.02, (pixels, length)))
                   .astype(np.float32))
    return out


def _same_splits(got, ref):
    assert type(got).__name__ == type(ref).__name__ == "ObjectSplits"
    assert list(got.splits) == list(ref.splits)
    for cls in got.splits:
        for part in ("cal", "val", "test"):
            a, b = got.splits[cls][part], ref.splits[cls][part]
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, b, err_msg=f"{cls}/{part}")
    for field in ("x_test", "y_test", "x_cal", "x_val", "x_test_in",
                  "x_test_out"):
        a, b = getattr(got, field), getattr(ref, field)
        assert a.dtype == b.dtype and a.shape == b.shape, field
        np.testing.assert_array_equal(a, b, err_msg=field)


def _cases():
    rng = np.random.default_rng(42)
    three = {"almond": _objects(rng, 10, 20, 64),
             "peanut": _objects(rng, 6, 15, 64, shift=1.0), "empty": []}
    nan = {"almond": _objects(rng, 10, 20, 64),
           "peanut": _objects(rng, 6, 15, 64, shift=1.0)}
    nan["almond"][0][3, :] = np.nan
    nan["almond"][1][2, 5] = np.inf
    return {
        "outliers_three_classes": (three, ["almond", "peanut", "empty"],
                                   "almond", 64, {}),
        "outliers_other_target": (three, ["almond", "peanut"], "peanut", 64,
                                  dict(random_state=3)),
        "nan_rows": (nan, ["almond", "peanut"], "almond", 64,
                     dict(use_pca=False)),
        "nan_rows_outliers": (nan, ["almond", "peanut"], "almond", 64, {}),
        "two_and_one_objects": ({"a": _objects(rng, 2, 10, 32),
                                 "b": _objects(rng, 1, 10, 32)},
                                ["a", "b"], "a", 32, dict(use_pca=False)),
        "dict_entries": ({"a": [{"spectral_data": o}
                                for o in _objects(rng, 5, 12, 32)]},
                         ["a"], "a", 32, dict(use_pca=False)),
        "dict_entries_outliers": ({"a": [{"spectral_data": o}
                                         for o in _objects(rng, 5, 12, 32)],
                                   "b": _objects(rng, 4, 9, 32, 0.5)},
                                  ["a", "b"], "b", 32,
                                  dict(cal_frac=0.6, val_frac=0.2,
                                       test_frac=0.2)),
    }


CASES = _cases()


@pytest.mark.parametrize("case", list(CASES))
def test_object_aware_splits_bit_equal_to_jax(case):
    data, classes, target, length, kw = CASES[case]
    ref = JS.object_aware_splits(data, classes, target, length,
                                 verbose=False, **kw)
    got = TS.object_aware_splits(data, classes, target, length,
                                 verbose=False, device="cpu", **kw)
    _same_splits(got, ref)


def test_object_aware_splits_verbose_and_errors(capsys):
    data, classes, target, length, _ = CASES["nan_rows_outliers"]
    TS.object_aware_splits(data, classes, target, length, device="cpu")
    out = capsys.readouterr().out
    assert "removed 2 NaN/inf samples" in out and "outliers" in out
    with pytest.raises(ValueError, match="sum to 1"):
        TS.object_aware_splits(data, classes, target, length, cal_frac=0.5,
                               val_frac=0.1, test_frac=0.1, device="cpu")
