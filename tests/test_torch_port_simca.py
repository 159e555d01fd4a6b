"""The port's SIMCA slice as a whole against ``ocm_tpu``, float64 on the CPU:
batched fit -> limits -> fused multi-class scoring -> decision, and the
carry-across of a JAX-fitted model into the port."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocm_tpu.models import simca as JS
from ocm_tpu_torch.models import simca as TS
from torch_port_data import K, LENGTH, make_data

RTOL = 1e-8
# (solver, decision_type, t2/q limit method): the bench's path first
CASES = [("rsvd", "alt", "Fdist", "jm"), ("svd", "alt", "Fdist", "jm"),
         ("rsvd", "dd", "chi2pom", "chi2pom"), ("svd", "ci", "Fdistrig", "chi2box")]


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


@functools.lru_cache(maxsize=None)
def _data():
    return make_data(seed=2)


def _jax_omega():
    s = K + 10
    return np.array(jax.random.normal(jax.random.PRNGKey(7), (LENGTH, s),
                                      jnp.float64))


@functools.lru_cache(maxsize=None)
def _fits(solver, decision_type, t2_method, q_method):
    cals, xs = _data()
    kw = dict(decision_type=decision_type, t2_method=t2_method,
              q_method=q_method, solver=solver)
    ref = jax.vmap(lambda x: JS.fit_simca(x, K, **kw))(jnp.asarray(cals))
    port = TS.fit_simca(cals, K, device="cpu",
                        omega=torch.as_tensor(_jax_omega()), **kw)
    return ref, port


def _close(got, ref, rtol=RTOL, what=""):
    ref = _np(ref)
    np.testing.assert_allclose(_np(got), ref, rtol=rtol,
                               atol=1e-12 * max(np.abs(ref).max(), 1e-300),
                               err_msg=what)


def _assert_accepts(acc, acc_ref, dred_ref, d_limit):
    """Identical decisions, except on rows whose reduced distance sits
    within 1e-8 relative of the critical distance."""
    differ = _np(acc) != _np(acc_ref)
    edge = np.abs(_np(dred_ref) - _np(d_limit)[:, None]) <= 1e-8 * np.abs(
        _np(d_limit)[:, None])
    assert not np.any(differ & ~edge)


@pytest.mark.parametrize("case", CASES, ids=["-".join(c) for c in CASES])
def test_fit_matches_jax(case):
    ref, port = _fits(*case)
    for field in ("mean", "d_limit", "t2_train", "q_train", "eigenvalues"):
        _close(getattr(port, field), getattr(ref, field), what=field)
    for res in ("t2_res", "q_res"):
        for field in ("limit", "dof", "scale"):
            _close(getattr(getattr(port, res), field),
                   getattr(getattr(ref, res), field), what=f"{res}.{field}")
    assert torch.all(port.n_samples == _data()[0].shape[1])
    # loadings up to the noise-bulk rotation: compare the projector
    proj = lambda p: _np(p).transpose(0, 2, 1) @ _np(p)
    _close(proj(port.components), proj(ref.components), rtol=1e-6,
           what="projector")


@pytest.mark.parametrize("case", CASES, ids=["-".join(c) for c in CASES])
def test_predict_classes_matches_jax(case):
    ref, port = _fits(*case)
    decision_type = case[1]
    xs = _data()[1]
    acc_r, dred_r, t2_r, q_r = JS.predict_classes(ref, jnp.asarray(xs),
                                                  decision_type)
    acc, dred, t2, q = TS.predict_classes(port, xs, decision_type)
    assert acc.shape == (3, xs.shape[0]) and acc.dtype == torch.bool
    _close(t2, t2_r, what="t2")
    _close(q, q_r, what="q")
    _close(dred, dred_r, what="dred")
    _assert_accepts(acc, acc_r, dred_r, ref.d_limit)
    # both decisions occur: in-class spectra accepted, the rest rejected
    assert 0.2 < _np(acc).mean() < 0.5


def test_single_model_paths_match_jax():
    ref, port = _fits(*CASES[0])
    xs = _data()[1]
    one_ref = jax.tree.map(lambda a: a[1], ref)
    one = jax.tree.map(lambda a: a[1], port)
    acc_r, dred_r, t2_r, q_r = JS.simca_decide(one_ref, jnp.asarray(xs))
    acc, dred, t2, q = TS.simca_decide(one, xs)
    assert t2.shape == (xs.shape[0],)
    _close(t2, t2_r)
    _close(q, q_r)
    _close(dred, dred_r)
    assert np.array_equal(_np(acc), _np(acc_r))
    for dt in ("alt", "dd"):
        for g, r in zip(TS.reduced_train_distances(port, dt),
                        jax.vmap(lambda m: JS.reduced_train_distances(m, dt))(ref)):
            _close(g, r)


def test_single_class_fit_equals_batched():
    cals = _data()[0]
    batched = _fits(*CASES[0])[1]
    one = TS.fit_simca(cals[2], K, solver="rsvd", device="cpu",
                       omega=torch.as_tensor(_jax_omega()))
    assert one.mean.shape == (LENGTH,) and one.d_limit.shape == ()
    _close(one.q_res.limit, batched.q_res.limit[2], rtol=1e-12)
    _close(one.t2_train, batched.t2_train[2], rtol=1e-10)


def test_fit_classes_matches_jax():
    cals, _ = _data()
    x = cals.reshape(-1, LENGTH)
    classes = np.repeat(np.array([7, 8, 9]), cals.shape[1])
    ref = JS.fit_classes(jnp.asarray(x), classes, [7, 8, 9], K)
    port = TS.fit_classes(x, classes, [7, 8, 9], K, device="cpu")
    _close(port.d_limit, ref.d_limit)
    _close(port.q_res.limit, ref.q_res.limit)
    _close(port.t2_train, ref.t2_train)
    # unequal class sizes: the masked fit, as in the reference
    ref = JS.fit_classes(jnp.asarray(x[:-1]), classes[:-1], [7, 8, 9], K)
    port = TS.fit_classes(x[:-1], classes[:-1], [7, 8, 9], K, device="cpu")
    _close(port.d_limit, ref.d_limit)
    _close(port.q_res.limit, ref.q_res.limit)
    _close(port.t2_train, ref.t2_train)
    with pytest.raises(ValueError):
        TS.fit_classes(x, classes, [7, 8, 9], 1000, device="cpu")


def _numpy_tree(model):
    """The dict ``ocm_tpu.models.simca.save_simca_model`` serializes."""
    tree = {}
    for f in model._fields:
        v = getattr(model, f)
        tree[f] = ({k: np.array(a) for k, a in v._asdict().items()}
                   if hasattr(v, "_asdict") else np.array(v))
    return tree


def test_jax_model_carries_across():
    ref, _ = _fits(*CASES[0])
    tree = _numpy_tree(ref)
    model = TS.simca_model_from_numpy(tree, device="cpu")
    xs = _data()[1]
    acc_r, dred_r, t2_r, q_r = JS.predict_classes(ref, jnp.asarray(xs))
    acc, dred, t2, q = TS.predict_classes(model, xs)
    _close(t2, t2_r)
    _close(q, q_r)
    _close(dred, dred_r)
    _assert_accepts(acc, acc_r, dred_r, ref.d_limit)
    back = TS.simca_model_to_numpy(model)
    assert back.keys() == tree.keys()
    for f, v in tree.items():
        if isinstance(v, dict):
            assert back[f].keys() == v.keys()
            for k in v:
                assert back[f][k].dtype == v[k].dtype
                assert np.array_equal(back[f][k], v[k])
        else:
            assert back[f].dtype == v.dtype and np.array_equal(back[f], v)
