"""Reference ``.pth`` import and export in the port
(``models/torch_import.py``, ``models/torch_export.py``,
``VAEScorer.from_torch_checkpoint``) against ``ocm_tpu``'s.

- An ``ocm_tpu`` bundle exported by both packages gives the same state
  dict: keys, shapes and values (1e-12).
- A float64 reference-format ``.pth`` imported by both packages decides
  and reconstructs the same (``decide_d2``, ``decide_f``, encode and
  decode; 1e-10), the port's module loading it with ``strict=True``.
- ``VAEScorer.from_torch_checkpoint`` screens as the bundle's scorer.
- A ``.pth`` with ``q_threshold`` and no other threshold imports as the
  reference imports it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocm_tpu.models import bundle as JB
from ocm_tpu.models import torch_export as JE
from ocm_tpu.models import torch_import as JI
from ocm_tpu.models import vae_decision as JD
from ocm_tpu.models.vae import ConvVAE1D as JVAE
from ocm_tpu.models.vae import init_vae
from ocm_tpu_torch.models import bundle as TB
from ocm_tpu_torch.models import torch_export as TE
from ocm_tpu_torch.models import torch_import as TI
from ocm_tpu_torch.models import vae_decision as TD
from ocm_tpu_torch.models.vae import ConvVAE1D as TVAE
from ocm_tpu_torch.serving import VAEScorer

ARCH = dict(input_length=64, latent_dim=6, conv_blocks=2, n_filters=8,
            kernel_size=9, stride=2, hidden_fc=32)
CPU = "cpu"


def _jax_bundle(arch=ARCH, seed=0, **model_kw):
    """An ``ocm_tpu`` bundle with every buffer set and BatchNorm running
    statistics away from their initial values."""
    model = JVAE(**arch, **model_kw)
    params, batch_stats = init_vae(model, jax.random.key(seed))
    rng = np.random.default_rng(seed + 3)
    length, k = arch["input_length"], arch["latent_dim"]
    batch_stats = jax.tree.map(
        lambda a: jnp.asarray(rng.uniform(0.5, 1.5, a.shape), a.dtype),
        batch_stats)
    a = rng.normal(size=(k, k))
    bundle = JB.new_bundle(params, batch_stats,
                           jnp.asarray(rng.normal(0, 1, length)),
                           jnp.asarray(rng.uniform(0.5, 2, length)), k)
    return model, bundle._replace(
        threshold=jnp.asarray(3.5), threshold_q=jnp.asarray(1.25),
        threshold_h=jnp.asarray(0.5), threshold_f=jnp.asarray(9.0),
        latent_mean=jnp.asarray(rng.normal(0, 1, k)),
        latent_cov_inv=jnp.asarray(a @ a.T + k * np.eye(k)))


def _port_model(**model_kw):
    return TVAE(**ARCH, **model_kw)


@pytest.mark.parametrize("model_kw", [{}, {"use_batchnorm": False,
                                           "dropout": 0.1}],
                         ids=["bn", "no_bn_dropout"])
def test_export_equals_reference_export(model_kw):
    jmodel, jbundle = _jax_bundle(**model_kw)
    tmodel = _port_model(**model_kw)
    tbundle = TB.ocm_bundle_from_numpy(jax.tree.map(np.asarray, jbundle),
                                       tmodel, CPU)
    ref = JE.torch_state_dict_from_bundle(jbundle, jmodel)
    got = TE.torch_state_dict_from_bundle(tbundle, tmodel)
    assert list(got) == list(ref)
    for k in ref:
        assert got[k].shape == ref[k].shape, k
        np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(), rtol=0,
                                   atol=1e-12, err_msg=k)
    # the export loads into the port's own module key for key
    tmodel.load_state_dict({k: v for k, v in got.items()
                            if k not in TI.BUFFERS}, strict=True)


def _pth64(tmp_path, model_kw=None):
    """A float64 reference-format checkpoint (the reference's own export
    of an ``ocm_tpu`` bundle, every tensor widened)."""
    jmodel, jbundle = _jax_bundle(**(model_kw or {}))
    state = {k: v.double() if v.is_floating_point() else v
             for k, v in JE.torch_state_dict_from_bundle(jbundle,
                                                         jmodel).items()}
    path = str(tmp_path / "ref64.pth")
    torch.save(state, path)
    return path, state


@pytest.fixture(scope="module")
def imported(tmp_path_factory):
    path, state = _pth64(tmp_path_factory.mktemp("pth"))
    jmodel = JVAE(**ARCH, dtype=jnp.float64)
    tmodel = _port_model()
    return (path, state, jmodel, JI.load_torch_checkpoint(path, jmodel),
            tmodel, TI.load_torch_checkpoint(path, tmodel, device=CPU))


def test_import_buffers_and_weights(imported):
    _, state, _, jb, _, tb = imported
    for name in TI.BUFFERS:
        np.testing.assert_array_equal(getattr(tb, name).numpy(),
                                      np.asarray(getattr(jb, name)))
        assert getattr(tb, name).dtype == torch.float64
    for k, v in tb.state_dict.items():
        np.testing.assert_array_equal(v.numpy(), state[k].numpy())


def _x(seed, n=24):
    rng = np.random.default_rng(seed)
    return rng.normal(0, 1, (n, ARCH["input_length"]))


def test_import_decides_and_reconstructs_as_reference(imported):
    _, _, jmodel, jb, tmodel, tb = imported
    x = _x(1)
    for jfn, tfn in ((JD.decide_d2, TD.decide_d2),
                     (JD.decide_f, TD.decide_f)):
        ref, got = jfn(jmodel, jb, jnp.asarray(x)), tfn(tmodel, tb, x)
        np.testing.assert_array_equal(got.accept.numpy(),
                                      np.asarray(ref.accept))
        for field in ref._fields[1:]:
            np.testing.assert_allclose(getattr(got, field).numpy(),
                                       np.asarray(getattr(ref, field)),
                                       rtol=1e-10, atol=1e-12)
    mu_j, lv_j = JB.encode(jmodel, jb, jnp.asarray(x))
    mu_t, lv_t = TB.encode(tmodel, tb, x)
    np.testing.assert_allclose(mu_t.numpy(), np.asarray(mu_j), rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(lv_t.numpy(), np.asarray(lv_j), rtol=1e-10,
                               atol=1e-12)
    z = np.random.default_rng(2).normal(size=(8, ARCH["latent_dim"]))
    np.testing.assert_allclose(TB.decode(tmodel, tb, z).numpy(),
                               np.asarray(JB.decode(jmodel, jb,
                                                    jnp.asarray(z))),
                               rtol=1e-10, atol=1e-12)


def test_from_torch_checkpoint_screens_as_the_bundle(imported):
    path, _, _, _, tmodel, tb = imported
    x = _x(3, 50)
    for variant in ("d2", "f", "full"):
        ref = VAEScorer(tmodel, tb, variant=variant, chunk_size=16).score(x)
        got = VAEScorer.from_torch_checkpoint(
            path, tmodel, device=CPU, variant=variant,
            chunk_size=16).score(x)
        assert set(got) == set(ref)
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k])


def test_q_threshold_alias_and_missing_thresholds(tmp_path):
    """Only ``q_threshold`` of the thresholds present: it becomes
    ``threshold_q``, the others 0, as the reference imports it."""
    _, state = _pth64(tmp_path)
    q = state["threshold_q"].clone()
    for name in ("threshold", "threshold_q", "threshold_h", "threshold_f",
                 "latent_mean", "latent_cov_inv"):
        del state[name]
    state["q_threshold"] = q
    path = str(tmp_path / "alias.pth")
    torch.save(state, path)
    jb = JI.load_torch_checkpoint(path, JVAE(**ARCH))
    tb = TI.load_torch_checkpoint(path, _port_model(), device=CPU)
    for name in ("threshold", "threshold_q", "threshold_h", "threshold_f",
                 "latent_mean", "latent_cov_inv"):
        np.testing.assert_array_equal(getattr(tb, name).numpy(),
                                      np.asarray(getattr(jb, name)))
    assert float(tb.threshold_q) == float(q) and float(tb.threshold) == 0.0


def test_import_without_batchnorm_and_bad_checkpoints(tmp_path):
    path, state = _pth64(tmp_path, {"use_batchnorm": False})
    tmodel = _port_model(use_batchnorm=False)
    jmodel = JVAE(**ARCH, use_batchnorm=False, dtype=jnp.float64)
    tb = TI.load_torch_checkpoint(path, tmodel, device=CPU)
    jb = JI.load_torch_checkpoint(path, jmodel)
    x = _x(4)
    np.testing.assert_allclose(TB.encode(tmodel, tb, x)[0].numpy(),
                               np.asarray(JB.encode(jmodel, jb,
                                                    jnp.asarray(x))[0]),
                               rtol=1e-10, atol=1e-12)
    # a checkpoint of another architecture is refused key by key
    with pytest.raises(RuntimeError, match="state_dict"):
        TI.bundle_from_torch_state_dict(state, _port_model(), device=CPU)
    with pytest.raises(ValueError, match="architecture"):
        TE.numpy_state_dict_from_bundle(tb, _port_model())


def test_stacked_bundle_export_needs_one_class():
    jmodel, jbundle = _jax_bundle()
    tmodel = _port_model()
    one = TB.ocm_bundle_from_numpy(jax.tree.map(np.asarray, jbundle),
                                   tmodel, CPU)
    stacked = TB.stack_bundles([one, one])
    with pytest.raises(ValueError, match="one class"):
        TE.numpy_state_dict_from_bundle(stacked, tmodel)
    sd = TE.numpy_state_dict_from_bundle(TB.class_slice(stacked, 1), tmodel)
    np.testing.assert_array_equal(
        sd["fc_mu.weight"], JE.numpy_state_dict_from_bundle(
            jbundle, jmodel)["fc_mu.weight"])


def test_default_device_is_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    path, _ = _pth64(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA"):
        TI.load_torch_checkpoint(path, _port_model())
