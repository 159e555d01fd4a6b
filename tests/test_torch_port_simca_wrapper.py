"""The port's sklearn-style ``SIMCA`` estimator against
``ocm_tpu.models.simca.SIMCA``, float64 on the CPU: predictions, the
printed metrics, the reference's quirks (Q1 ``transform`` returns the last
class, Q7 'dd' shares the last class's dofs, Q10 ``score`` returns the
specificity, 'dd' forces 'chi2pom'), and how many scoring calls
``predict`` makes (one for every class at one k, one a class otherwise).
"""

import numpy as np
import pytest
import torch

from ocm_tpu.models import simca as JS
from ocm_tpu_torch.models import simca as TS
from oracles import make_class_spectra


@pytest.fixture(scope="module")
def three_class():
    rng = np.random.default_rng(0)
    x = np.concatenate([make_class_spectra(rng, n, 50, center_shift=s)
                        for n, s in ((60, 0.0), (50, 0.003), (40, 0.006))])
    y = np.concatenate([np.zeros(60), np.ones(50), np.full(40, 2)]).astype(int)
    return x, y


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _pair(x, y, **kw):
    ref = JS.SIMCA(verbose=False, **kw).fit(x, y)
    ours = TS.SIMCA(verbose=False, device="cpu", **kw).fit(x, y)
    return ref, ours


# (decision type, n_components): one k and a k a class
CASES = [("alt", 4), ("sim", [3, 4, 5]), ("ci", 3), ("dd", [4, 4, 2])]


@pytest.mark.parametrize("decision,ncomp", CASES,
                         ids=[f"{d}-{n}" for d, n in CASES])
def test_predict_matches_jax(three_class, decision, ncomp, capsys):
    x, y = three_class
    ref, ours = _pair(x, y, type=decision, n_components=ncomp,
                      model_class=[0, 1, 2])
    printed = capsys.readouterr().out
    if decision == "dd":
        assert printed == "t2lim set as chi2pom\nqlim set as chi2pom\n" * 2
        assert ours.t2lim == ours.qlim == "chi2pom"
    pred, pred_ref = ours.predict(x, y_true=y), ref.predict(x, y_true=y)
    assert pred.dtype == pred_ref.dtype == np.float64
    assert np.array_equal(pred, pred_ref)
    assert 0 < pred.mean() < 1
    assert ours.metrics.keys() == ref.metrics.keys()
    for cls in ref.metrics:
        for key, v in ref.metrics[cls].items():
            assert ours.metrics[cls][key] == pytest.approx(v, rel=1e-12)


def test_verbose_prints_as_the_reference(three_class, capsys):
    x, y = three_class
    JS.SIMCA(n_components=3, model_class=[0, 2]).fit(x, y).predict(x, y)
    printed_ref = capsys.readouterr().out
    TS.SIMCA(n_components=3, model_class=[0, 2], device="cpu").fit(
        x, y).predict(x, y)
    assert capsys.readouterr().out == printed_ref
    assert "Confusion Matrix for class 2" in printed_ref


def test_q1_transform_returns_last_class(three_class):
    x, y = three_class
    ref, multi = _pair(x, y, n_components=4, model_class=[0, 1, 2])
    single = TS.SIMCA(n_components=4, model_class=2, verbose=False,
                      device="cpu").fit(x, y)
    for a, b, c in zip(multi.transform(x), single.transform(x),
                       ref.transform(x)):
        assert torch.equal(a, b)
        np.testing.assert_allclose(_np(a), np.asarray(c), rtol=1e-9)


def test_q7_dd_shared_state(three_class):
    x, y = three_class
    ref, compat = _pair(x, y, n_components=4, model_class=[0, 1, 2],
                        type="dd", compat_dd_shared_state=True)
    fixed = TS.SIMCA(n_components=4, model_class=[0, 1, 2], type="dd",
                     verbose=False, device="cpu",
                     compat_dd_shared_state=False).fit(x, y)
    m0 = compat._dd_limits(compat._model[0])
    assert float(m0.t2_res.dof) == float(compat._model[2].t2_res.dof)
    assert float(m0.d_limit) == float(compat._model[0].d_limit)
    assert float(fixed._dd_limits(fixed._model[0]).t2_res.dof) == float(
        fixed._model[0].t2_res.dof)
    # the shared state genuinely differs across classes here
    assert float(compat._model[0].t2_res.scale) != float(
        compat._model[2].t2_res.scale)
    for cls in (0, 1, 2):
        for res in ("t2_res", "q_res"):
            for a, b in zip(getattr(compat._model[cls], res),
                            getattr(ref._model[cls], res)):
                assert float(a) == pytest.approx(float(b), rel=1e-9)
    assert np.array_equal(compat.predict(x), ref.predict(x))


def test_q10_score_returns_specificity(three_class):
    x, y = three_class
    ref, ours = _pair(x, y, n_components=4, model_class=0)
    s = ours.score(x, y)
    assert s == pytest.approx(ours.metrics[0]["specificity"], abs=1e-12)
    assert s == pytest.approx(ref.score(x, y), rel=1e-12)
    assert 0.0 < s < 100.0


def test_predict_scoring_calls(three_class, monkeypatch):
    """One k for every class: one scoring call (one K1 launch on the card)
    for all of them; a k a class: one call a class."""
    x, y = three_class
    calls = []
    real = TS.t2q_scores_multiclass

    def counted(xs, means, *args):
        calls.append(means.shape[0])
        return real(xs, means, *args)

    monkeypatch.setattr(TS, "t2q_scores_multiclass", counted)
    for ncomp, want in ((4, [3]), ([3, 4, 5], [1, 1, 1])):
        est = TS.SIMCA(n_components=ncomp, model_class=[0, 1, 2],
                       verbose=False, device="cpu").fit(x, y)
        calls.clear()
        est.predict(x)
        assert calls == want
    single = TS.SIMCA(n_components=4, model_class=1, verbose=False,
                      device="cpu").fit(x, y)
    calls.clear()
    single.predict(x)
    assert calls == [1]


def test_params_fitting_and_errors(three_class):
    x, y = three_class
    est = TS.SIMCA(n_components=3, solver="rsvd", device="cpu",
                   verbose=False)
    params = est.get_params()
    assert params["device"] == "cpu" and params["solver"] == "rsvd"
    assert sorted(params) == sorted(
        list(JS.SIMCA().get_params()) + ["device"])
    clone = TS.SIMCA(**params).set_params(n_components=2)
    assert clone.n_components == 2 and clone.device == "cpu"
    # model_class None: every class of y; the randomized fit decides as
    # the dense one on these separated classes
    est.fit(x, y)
    assert est.model_class == [0, 1, 2] and est.n_features_in_ == 50
    dense = TS.SIMCA(n_components=3, device="cpu", verbose=False).fit(x, y)
    assert np.mean(est.predict(x) == dense.predict(x)) > 0.98
    with pytest.raises(RuntimeError, match="not fitted"):
        TS.SIMCA(device="cpu").predict(x)
    with pytest.raises(ValueError, match="no samples"):
        TS.SIMCA(model_class=9, device="cpu").fit(x, y)
    with pytest.raises(ValueError, match="must be in"):
        TS.SIMCA(n_components=41, model_class=2, device="cpu").fit(x, y)
    with pytest.raises(ValueError, match="length must match"):
        TS.SIMCA(n_components=[2, 3], model_class=[0, 1, 2],
                 device="cpu").fit(x, y)
