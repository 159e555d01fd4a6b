"""Model files between the packages: the port's msgpack codec
(``ocm_tpu_torch.utils.msgpack_io``) against flax's, and each model kind's
``save_*``/``load_*`` pair against ``ocm_tpu``'s, on the CPU.

A file written by either package loads in the other with every leaf
bit-equal; port-written files of ``SIMCAModel``, ``VAESIMCAModel`` and
``SpectraMoments`` are byte-equal to flax's for the same arrays.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from ocm_tpu.models import bundle as JBd
from ocm_tpu.models import simca as JS
from ocm_tpu.models import streaming as JM
from ocm_tpu.models import vae as JV
from ocm_tpu.models import vaesimca as JVS
from ocm_tpu_torch.models import bundle as TBd
from ocm_tpu_torch.models import simca as TS
from ocm_tpu_torch.models import streaming as TM
from ocm_tpu_torch.models import vae as TV
from ocm_tpu_torch.models import vaesimca as TVS
from ocm_tpu_torch.utils import msgpack_io as M
from torch_port_data import (K, VAE_SMALL, bundle_as_numpy, make_data,
                             perturb_bn, simca_numpy_tree, vae_bundle_pair,
                             vae_classes)


def _rng():
    return np.random.default_rng(3)


TREES = {
    "scalars": lambda r: {
        "ints": {str(v): v for v in (0, 1, 127, 128, 255, 256, 65535, 65536,
                                     2 ** 32, 2 ** 40, -1, -32, -33, -128,
                                     -129, -2 ** 15 - 1, -2 ** 31 - 1)},
        "floats": {"a": 1.5, "b": -0.0, "c": 1e300},
        "flags": {"t": True, "f": False, "none": None},
        "text": {"short": "abc", "long": "z" * 40, "longer": "y" * 300,
                 "utf8": "μ-naïve", "bin": b"\x00\x01", "bin16": b"q" * 300},
        "keys": {f"k{i:02d}": i for i in range(20)}},
    "arrays": lambda r: {
        "f64": r.normal(size=(3, 5)), "f32": r.normal(size=(7,)).astype(
            np.float32),
        "f16": np.ones(3, np.float16), "i64": np.arange(6).reshape(2, 3),
        "i32": np.asarray(480, np.int32), "u16": np.arange(9, dtype=np.uint16),
        "i8": np.array([-3, 4], np.int8), "b": np.array([True, False]),
        "c64": np.array([1 + 2j], np.complex64), "empty": np.zeros((0, 4)),
        "f_order": np.asfortranarray(r.normal(size=(4, 3))),
        "nested": {"s64": np.float64(2.5), "s32": np.int32(-7),
                   "sb": np.bool_(True), "big": r.normal(size=(64, 64))}},
}


@pytest.mark.parametrize("name", sorted(TREES))
def test_codec_bytes_equal_flax(name):
    tree = TREES[name](_rng())
    ours, theirs = M.serialize(tree), serialization.msgpack_serialize(tree)
    assert ours == theirs
    assert M.serialize(tree, sort_keys=False) == serialization.to_bytes(tree)

    def same(a, b):
        if isinstance(a, dict):
            assert list(a) == list(b)
            for k in a:
                same(a[k], b[k])
        else:
            assert type(a) is type(b) and np.array_equal(a, b)
            if isinstance(a, np.ndarray):
                assert a.dtype == b.dtype and a.shape == b.shape
    same(M.restore(theirs), serialization.msgpack_restore(ours))


def test_codec_chunked_layout(monkeypatch):
    """Arrays above MAX_CHUNK_SIZE bytes go in flax's chunked layout, at
    the top of the tree, in nested maps, and as the whole tree."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(M, "MAX_CHUNK_SIZE", 64)
    r = _rng()
    tree = {"x": r.normal(size=(5, 7)), "small": np.ones(3),
            "inner": {"z": np.arange(40, dtype=np.int32)}}
    ours = M.serialize(tree)
    assert ours == serialization.msgpack_serialize(tree)
    assert b"__msgpack_chunked_array__" in ours
    for got in (M.restore(ours), serialization.msgpack_restore(ours)):
        np.testing.assert_array_equal(got["x"], tree["x"])
        np.testing.assert_array_equal(got["inner"]["z"], tree["inner"]["z"])
    whole = r.normal(size=(3, 9))
    assert M.serialize(whole) == serialization.msgpack_serialize(whole)
    np.testing.assert_array_equal(M.restore(M.serialize(whole)), whole)


def test_codec_refuses_what_it_cannot_map():
    bf16 = serialization.msgpack_serialize(
        {"w": np.asarray(jnp.ones(3, jnp.bfloat16))})
    with pytest.raises(ValueError, match="bfloat16"):
        M.restore(bf16)
    with pytest.raises(ValueError, match="object"):
        M.serialize({"o": np.array([object()])})
    with pytest.raises(TypeError, match="set"):
        M.serialize({"s": {1, 2}})
    with pytest.raises(ValueError, match="truncated"):
        M.restore(M.serialize({"a": np.ones(4)})[:-3])


def _leaves_equal(a, b):
    """Every leaf of two nested dicts (or NamedTuples) bit-equal, with the
    same dtype and shape."""
    a = a._asdict() if hasattr(a, "_asdict") else a
    b = b._asdict() if hasattr(b, "_asdict") else b
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _leaves_equal(a[k], b[k])
        return
    a, b = (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
            for v in (a, b))
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


@pytest.fixture(scope="module")
def simca_models():
    cals, _ = make_data(seed=4, n_cal=40)
    jm = jax.vmap(lambda x: JS.fit_simca(x, K))(jnp.asarray(cals))
    tm = TS.fit_simca(cals, K, device="cpu")
    return jm, tm


def test_simca_model_files_cross(simca_models, tmp_path):
    jm, tm = simca_models
    jpath, tpath = tmp_path / "jax.msgpack", tmp_path / "port.msgpack"
    JS.save_simca_model(str(jpath), jm)
    loaded = TS.load_simca_model(jpath, device="cpu")
    _leaves_equal(TS.simca_model_to_numpy(loaded), simca_numpy_tree(jm))

    assert TS.save_simca_model(tpath, tm) == tpath
    assert tpath.read_bytes() == serialization.msgpack_serialize(
        TS.simca_model_to_numpy(tm))
    _leaves_equal(simca_numpy_tree(JS.load_simca_model(str(tpath))),
                  TS.simca_model_to_numpy(tm))
    # a reloaded model scores bit-equal
    back = TS.load_simca_model(tpath, device="cpu")
    x = make_data(seed=5)[1]
    for a, b in zip(TS.predict_classes(tm, x), TS.predict_classes(back, x)):
        assert torch.equal(a, b)


@pytest.fixture(scope="module")
def vae_setup():
    (x_cal,), _ = vae_classes(1)
    jmodel, jb, tmodel, tb = vae_bundle_pair(x_cal)
    return x_cal, jmodel, jb, tmodel, tb


def test_vaesimca_model_files_cross(vae_setup, tmp_path):
    x_cal, jmodel, jb, tmodel, tb = vae_setup
    jvs = JVS.fit_vaesimca(jmodel, jb, jnp.asarray(x_cal))
    tvs = TVS.fit_vaesimca(tmodel, tb, x_cal)
    jpath, tpath = tmp_path / "jax.msgpack", tmp_path / "port.msgpack"
    JVS.save_vaesimca_model(str(jpath), jvs)
    _leaves_equal(TVS.load_vaesimca_model(jpath, device="cpu"),
                  bundle_as_numpy(jvs))
    TVS.save_vaesimca_model(tpath, tvs)
    tree = {f: getattr(tvs, f).numpy() for f in tvs._fields}
    assert tpath.read_bytes() == serialization.msgpack_serialize(tree)
    _leaves_equal(bundle_as_numpy(JVS.load_vaesimca_model(str(tpath))), tree)


def test_moments_files_cross(tmp_path):
    cals, _ = make_data(seed=6, n_cal=30)
    x = cals.reshape(-1, cals.shape[-1])
    y = np.repeat(np.arange(cals.shape[0]), cals.shape[1])
    jmom = JM.moments_update_classes(
        JM.moments_init_classes(3, x.shape[1], jnp.float64), jnp.asarray(x),
        y, [0, 1, 2])
    tmom = TM.moments_update_classes(
        TM.moments_init_classes(3, x.shape[1], torch.float64, device="cpu"),
        x, y, [0, 1, 2])
    jpath, tpath = tmp_path / "jax.msgpack", tmp_path / "port.msgpack"
    JM.save_moments(str(jpath), jmom)
    _leaves_equal(TM.load_moments(jpath, device="cpu"), bundle_as_numpy(jmom))
    TM.save_moments(tpath, tmom)
    tree = {f: a.numpy() for f, a in tmom._asdict().items()}
    assert tpath.read_bytes() == serialization.to_bytes(tree)
    _leaves_equal(bundle_as_numpy(JM.load_moments(str(tpath),
                                                  length=x.shape[1])), tree)
    # a reloaded statistic refits to the same model
    again = TM.fit_classes_moments(TM.load_moments(tpath, device="cpu"), K)
    first = TM.fit_classes_moments(tmom, K)
    for a, b in zip(TS.simca_model_to_numpy(again).values(),
                    TS.simca_model_to_numpy(first).values()):
        _leaves_equal(a, b)


@pytest.mark.parametrize("arch", [{}, {"use_batchnorm": False},
                                  {"dropout": 0.1}],
                         ids=["bn", "no_bn", "dropout"])
def test_state_dict_numpy_inverse(arch):
    """``vae_state_dict_to_numpy`` inverts ``vae_state_dict_from_numpy``
    bit for bit, for every layer layout the index step takes."""
    jmodel = JV.ConvVAE1D(**VAE_SMALL, **arch, dtype=jnp.float64)
    params, stats = JV.init_vae(jmodel, jax.random.key(1))
    params, stats = jax.tree.map(lambda a: np.asarray(a, np.float64),
                                 (params, stats))
    if stats:
        params, stats = perturb_bn(params, stats)
    tmodel = TV.ConvVAE1D(**VAE_SMALL, **arch)
    sd = TV.vae_state_dict_from_numpy(params, stats, tmodel)
    tmodel.double().load_state_dict(sd)
    p2, s2 = TV.vae_state_dict_to_numpy(tmodel.state_dict(), tmodel)
    _leaves_equal(p2, params)
    _leaves_equal(s2, stats or {})


def test_bundle_files_cross(vae_setup, tmp_path):
    x_cal, jmodel, jb, tmodel, tb = vae_setup
    jpath, tpath = tmp_path / "jax.msgpack", tmp_path / "port.msgpack"
    JBd.save_bundle(str(jpath), jb)
    loaded = TBd.load_bundle(jpath, tmodel, device="cpu")
    _leaves_equal(loaded.state_dict, tb.state_dict)
    for f in TBd.OCMBundle._fields[1:]:
        _leaves_equal(getattr(loaded, f), np.asarray(getattr(jb, f)))

    # a trained bundle's BatchNorm counters are not in the format
    trained = tb._replace(state_dict={
        k: v + 5 if k.endswith("num_batches_tracked") else v
        for k, v in tb.state_dict.items()})
    TBd.save_bundle(tpath, trained, tmodel)
    back = JBd.load_bundle(str(tpath), jb)
    _leaves_equal(bundle_as_numpy(back)._asdict(),
                  bundle_as_numpy(jb)._asdict())
    _leaves_equal(TBd.load_bundle(tpath, tmodel, device="cpu").state_dict,
                  tb.state_dict)
    # and the reloaded bundle decodes as the original
    z = np.random.default_rng(0).normal(size=(5, VAE_SMALL["latent_dim"]))
    assert torch.equal(TBd.decode(tmodel, loaded, z), TBd.decode(tmodel, tb, z))
