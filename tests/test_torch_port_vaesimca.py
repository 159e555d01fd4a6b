"""The port's VAE-SIMCA (``ocm_tpu_torch.models.vaesimca``, variant 5)
against ``ocm_tpu.models.vaesimca``, float64 on the CPU.

One untrained bundle in both packages (JAX ``init_vae`` weights with random
BatchNorm statistics, carried across) fits latent-SIMCA limits on seeded
calibration spectra.  The reference's own limit formulas (quirk Q5) run
over every T2 x Q x decision combination, with the double standardization
both ways; the classical engines (``classical_limits=True``, whose F and
chi^2 quantiles make each JAX fit take over a second eagerly) over every
T2 x Q pair, the decision types and standardization cycling.  Tolerance
1e-8 relative (f64; convolutions summed in another order, eigh-based
pseudo-inverses, bisected quantiles); accepts must be equal.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocm_tpu.models import vaesimca as JS
from ocm_tpu_torch.models import vaesimca as TS
from torch_port_data import bundle_as_numpy, vae_bundle_pair, vae_classes

RTOL, ATOL = 1e-8, 1e-10
T2LIMS = ["perc", "chi2", "Fdist", "chi2pom"]
QLIMS = ["perc", "jm", "chi2pom"]
DECISIONS = ["sim", "alt", "ci", "dd"]
GRID = [(t2, q, d, False, compat)
        for compat in (True, False)
        for t2, q, d in itertools.product(T2LIMS, QLIMS, DECISIONS)]
GRID += [(t2, q, DECISIONS[i % 4], True, i % 2 == 0)
         for i, (t2, q) in enumerate(itertools.product(T2LIMS, QLIMS))]


def _close(got, ref, what):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(ref, dtype=got.dtype),
                               rtol=RTOL, atol=ATOL, err_msg=what)


@pytest.fixture(scope="module")
def setup():
    (x_cal,), x_test = vae_classes(1)
    return (x_cal, x_test, *vae_bundle_pair(x_cal))


def _ids(case):
    t2, q, d, classical, compat = case
    return (f"{t2}-{q}-{d}" + ("-classical" if classical else "")
            + ("" if compat else "-single_std"))


@pytest.mark.parametrize("case", GRID, ids=_ids)
def test_fit_vaesimca_matches_jax(setup, case):
    x_cal, _, jm, jb, tm, tb = setup
    t2lim, qlim, decision, classical, compat = case
    kw = dict(decision_type=decision, t2lim=t2lim, qlim=qlim,
              compat_double_standardize=compat, classical_limits=classical)
    ref = JS.fit_vaesimca(jm, jb, x_cal, **kw)
    got = TS.fit_vaesimca(tm, tb, x_cal, **kw)
    for name in JS.VAESIMCAModel._fields:
        _close(getattr(got, name), getattr(ref, name), name)


@pytest.mark.parametrize("decision", DECISIONS)
@pytest.mark.parametrize("compat", [True, False], ids=["double_std",
                                                       "single_std"])
def test_predict_vaesimca_and_reduced_d_match_jax(setup, decision, compat):
    x_cal, x_test, jm, jb, tm, tb = setup
    jvs = JS.fit_vaesimca(jm, jb, x_cal, decision, "chi2pom", 0.95,
                          "chi2pom", compat_double_standardize=compat)
    tvs = TS.vaesimca_model_from_numpy(bundle_as_numpy(jvs), device="cpu")
    ref = JS.predict_vaesimca(jm, jb, jvs, jnp.asarray(x_test), decision,
                              compat)
    got = TS.predict_vaesimca(tm, tb, tvs, x_test, decision, compat)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    assert 0 < int(got[0].sum()) < len(x_test)
    _close(got[1], ref[1], "t2")
    _close(got[2], ref[2], "q")
    _close(TS.reduced_d(tvs, got[1], got[2], decision),
           JS.reduced_d(jvs, ref[1], ref[2], decision), "reduced d")


def test_vaesimca_wrapper_matches_jax(setup):
    x_cal, x_test, jm, jb, tm, tb = setup
    ref = JS.VAESIMCA(jm, jb, type="ci", t2lim="Fdist", qlim="jm")
    got = TS.VAESIMCA(tm, tb, type="ci", t2lim="Fdist", qlim="jm")
    with pytest.raises(RuntimeError, match="fit_thresholds"):
        got.predict(x_test)
    ref.fit_thresholds(x_cal, class_label=2)
    got.fit_thresholds(x_cal, class_label=2)
    assert got.model_class == [2]
    for g, r, what in zip(got.predict(x_test), ref.predict(x_test),
                          ("accept", "t2", "q")):
        _close(g, r, what)


def test_unknown_limit_types_raise(setup):
    x_cal, _, _, _, tm, tb = setup
    with pytest.raises(ValueError, match="T2 limit type"):
        TS.fit_vaesimca(tm, tb, x_cal, t2lim="Fdistrig")
    with pytest.raises(ValueError, match="Q limit type"):
        TS.fit_vaesimca(tm, tb, x_cal, qlim="chi2box")
    with pytest.raises(ValueError, match="D type"):
        TS.fit_vaesimca(tm, tb, x_cal, decision_type="rd")
