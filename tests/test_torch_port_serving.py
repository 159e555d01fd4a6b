"""The port's ``VAEScorer`` (``ocm_tpu_torch.serving``) and ``stack_bundles``
against ``ocm_tpu.serving.VAEScorer``, float64 on the CPU.

Three classes, each an untrained JAX bundle (``init_vae`` weights with
random BatchNorm statistics) calibrated by JAX's ``fit_thresholds`` and
``fit_vaesimca`` and carried across, so that both scorers hold the same
models.  Chunks of 64 over 120 spectra leave a ragged tail (padded by
repeating the last row, which variant 'f''s batch statistics see).
Tolerance 1e-8 relative (f64, sums in another order, bisected chi^2
quantiles); accepts must be equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocm_tpu.models import bundle as JBd
from ocm_tpu.models import vae_decision as JD
from ocm_tpu.models import vaesimca as JS
from ocm_tpu.serving import VAEScorer as JScorer
from ocm_tpu_torch.models import bundle as TBd
from ocm_tpu_torch.models import vae as TV
from ocm_tpu_torch.models import vaesimca as TS
from ocm_tpu_torch.serving import VAEScorer, _pad_chunk
from torch_port_data import (VAE_SMALL, bundle_as_numpy, vae_bundle_pair,
                             vae_classes)

RTOL, ATOL = 1e-8, 1e-10
CHUNK = 64
VARIANTS = [("d2", {}), ("d2_q", {}), ("f", {}), ("f", {"pin_f_stats": True}),
            ("full", {}), ("vaesimca", {})]


def _ids(v):
    return v[0] + ("_pinned" if v[1] else "")


@pytest.fixture(scope="module")
def classes():
    """(JAX model, port model, JAX bundles, port bundles, JAX and port
    VAE-SIMCA models, test spectra) for three classes."""
    cals, x_test = vae_classes(3, n_test_per=30)
    jbs, tbs, jvs, tvs = [], [], [], []
    for c, x_cal in enumerate(cals):
        jm, jb, tm, _ = vae_bundle_pair(x_cal, key=10 + c, bn_seed=5 + c)
        jb = JD.fit_thresholds(jm, jb, x_cal, loss_type="euclidean")
        jbs.append(jb)
        tbs.append(TBd.ocm_bundle_from_numpy(bundle_as_numpy(jb), tm,
                                             device="cpu"))
        jvs.append(JS.fit_vaesimca(jm, jb, x_cal))
        tvs.append(TS.vaesimca_model_from_numpy(bundle_as_numpy(jvs[-1]),
                                                device="cpu"))
    return jm, tm, jbs, tbs, jvs, tvs, x_test


def _kw(variant, vs):
    name, extra = variant
    kw = dict(variant=name, loss_type="euclidean", chunk_size=CHUNK, **extra)
    if name == "vaesimca":
        kw["vaesimca_model"] = vs
    return kw


def _compare(got, ref):
    assert set(got) == set(ref)
    np.testing.assert_array_equal(got["accept"], np.asarray(ref["accept"]))
    for k in ref:
        if k != "accept":
            np.testing.assert_allclose(got[k], np.asarray(ref[k]), rtol=RTOL,
                                       atol=ATOL, err_msg=k)


@pytest.mark.parametrize("variant", VARIANTS, ids=_ids)
def test_single_class_scorer_matches_jax(classes, variant):
    jm, tm, jbs, tbs, jvs, tvs, x = classes
    ref = JScorer(jm, jbs[0], **_kw(variant, jvs[0])).score(x)
    got = VAEScorer(tm, tbs[0], **_kw(variant, tvs[0])).score(x)
    assert got["accept"].shape == (len(x),)
    assert 0 < got["accept"].sum() < len(x) or variant[0] == "full"
    _compare(got, ref)


@pytest.mark.parametrize("variant", VARIANTS, ids=_ids)
def test_stacked_scorer_matches_jax_and_single(classes, variant):
    jm, tm, jbs, tbs, jvs, tvs, x = classes
    jkw = _kw(variant, JBd.stack_bundles(jvs))
    tkw = _kw(variant, TBd.stack_bundles(tvs))
    ref = JScorer(jm, JBd.stack_bundles(jbs), **jkw).score(x)
    got = VAEScorer(tm, TBd.stack_bundles(tbs), **tkw).score(x)
    assert got["accept"].shape == (len(x), 3)
    _compare(got, ref)
    for c in range(3):
        single = VAEScorer(tm, tbs[c], **_kw(variant, tvs[c])).score(x)
        for k, v in single.items():
            np.testing.assert_array_equal(got[k][:, c], v, err_msg=k)


def test_prepare_prefetch_and_stream_agree(classes):
    _, tm, _, tbs, _, tvs, x = classes
    scorer = VAEScorer(tm, tbs[1], variant="f", chunk_size=CHUNK)
    seq = scorer.score(x, prefetch=0)
    for out in (scorer.score(x, prefetch=1), scorer.score(x, prefetch=3),
                scorer.score_prepared(scorer.prepare(x))):
        for k in seq:
            np.testing.assert_array_equal(out[k], seq[k], err_msg=k)
    # frames are scored (and padded) one by one: variant 'd2' is per-row
    d2 = VAEScorer(tm, tbs[1], variant="d2", chunk_size=CHUNK)
    frames = list(d2.score_stream([x[:70], x[70:]]))
    np.testing.assert_array_equal(
        np.concatenate([f["accept"] for f in frames]), d2.score(x)["accept"])
    assert scorer.score(x[:0]) == {} and scorer.score_prepared([]) == {}


def test_pad_chunk_repeats_the_last_row():
    x = np.arange(12.0).reshape(4, 3)
    out, n = _pad_chunk(x, 6)
    assert n == 4 and out.shape == (6, 3)
    np.testing.assert_array_equal(out[4:], x[[3, 3]])
    assert _pad_chunk(x, 4)[0] is x


def test_scorer_keeps_resident_modules(classes):
    _, tm, _, tbs, _, _, x = classes
    scorer = VAEScorer(tm, TBd.stack_bundles(tbs[:2]), variant="d2",
                       chunk_size=CHUNK)
    assert len(scorer.modules) == 2
    assert all(not m.training for m in scorer.modules)
    assert all(not p.requires_grad for m in scorer.modules
               for p in m.parameters())
    loads = []
    for m in scorer.modules:
        m.register_load_state_dict_post_hook(lambda *a: loads.append(a))
    scorer.score(x)
    assert loads == []


def test_scorers_in_threads_keep_cudnn_deterministic(classes):
    """The package selects cuDNN's deterministic algorithms once, when it
    loads; scorers deciding in several threads at once all see it, leave
    it as they found it, and give the results of a sequential run."""
    from concurrent.futures import ThreadPoolExecutor

    _, tm, _, tbs, _, tvs, x = classes
    assert torch.backends.cudnn.deterministic
    scorers = [VAEScorer(tm, tbs[c], variant="vaesimca",
                         vaesimca_model=tvs[c], chunk_size=16)
               for c in range(3)]
    seen = []
    for scorer in scorers:
        fn = scorer._fn
        scorer._fn = lambda xc, fn=fn: (
            seen.append(torch.backends.cudnn.deterministic), fn(xc))[1]
    seq = [s.score(x, prefetch=0) for s in scorers]
    with ThreadPoolExecutor(max_workers=3) as ex:
        par = list(ex.map(lambda s: s.score(x, prefetch=0), scorers))
    assert all(seen) and len(seen) == 2 * 3 * -(-len(x) // 16)
    assert torch.backends.cudnn.deterministic
    for a, b in zip(seq, par):
        for k in a:
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)


def test_shape1_threshold_is_single_class(classes):
    _, tm, _, tbs, _, _, x = classes
    b1 = tbs[0]._replace(threshold=tbs[0].threshold.reshape(1))
    out = VAEScorer(tm, b1, variant="d2", chunk_size=CHUNK).score(x)
    ref = VAEScorer(tm, tbs[0], variant="d2", chunk_size=CHUNK).score(x)
    np.testing.assert_array_equal(out["accept"], ref["accept"])


def test_scorer_validation_errors(classes):
    _, tm, _, tbs, _, tvs, _ = classes
    stacked = TBd.stack_bundles(tbs)
    with pytest.raises(ValueError, match="pin_f_stats"):
        VAEScorer(tm, tbs[0], variant="d2", pin_f_stats=True)
    with pytest.raises(ValueError, match="unknown variant"):
        VAEScorer(tm, tbs[0], variant="nope")
    with pytest.raises(ValueError, match="needs vaesimca_model"):
        VAEScorer(tm, tbs[0], variant="vaesimca")
    with pytest.raises(ValueError, match="stacked"):
        VAEScorer(tm, stacked, variant="vaesimca", vaesimca_model=tvs[0])
    with pytest.raises(ValueError, match="inconsistent"):
        VAEScorer(tm, stacked._replace(threshold=stacked.threshold[:2]),
                  variant="d2")
    # the bf16 twin reduces float32 bundles; these are float64
    with pytest.raises(ValueError, match="float32"):
        VAEScorer(tm, tbs[0], compute_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="bfloat16"):
        VAEScorer(tm, tbs[0], compute_dtype=torch.float16)
    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
        VAEScorer(tm, tbs[0], mesh=object())
    # a reference .pth is served since models/torch_import.py's port
    # (tests/test_torch_port_torch_io.py); a missing file raises
    with pytest.raises(FileNotFoundError):
        VAEScorer.from_torch_checkpoint("no_such_model.pth", tm, device="cpu")


def test_stack_bundles_validates():
    with pytest.raises(ValueError, match="at least one"):
        TBd.stack_bundles([])
    kw = {k: v for k, v in VAE_SMALL.items() if k != "latent_dim"}

    def bundle_of(latent_dim, **over):
        model = TV.ConvVAE1D(**{**kw, **over}, latent_dim=latent_dim)
        return TBd.new_bundle(model.state_dict(), torch.zeros(48),
                              torch.ones(48), latent_dim)

    with pytest.raises(ValueError, match="shapes differ"):
        TBd.stack_bundles([bundle_of(4), bundle_of(6)])
    with pytest.raises(ValueError, match="structure"):
        TBd.stack_bundles([bundle_of(4), bundle_of(4, conv_blocks=3)])
    stacked = TBd.stack_bundles([bundle_of(4), bundle_of(4)])
    assert stacked.latent_mean.shape == (2, 4)
    assert stacked.state_dict["fc_mu.weight"].shape == (2, 4, 32)
    one = TBd.class_slice(stacked, 1)
    assert one.threshold.shape == () and one.latent_cov_inv.shape == (4, 4)


def test_stack_bundles_matches_jax(classes):
    """Every stacked leaf equals JAX's stack of the same bundles, mapped
    through the weight carrier."""
    jm, tm, jbs, tbs, jvs, tvs, _ = classes
    got = TBd.stack_bundles(tbs)
    for c, jb in enumerate(jbs):
        one = TBd.ocm_bundle_from_numpy(bundle_as_numpy(jb), tm, device="cpu")
        for k, v in one.state_dict.items():
            torch.testing.assert_close(got.state_dict[k][c], v, rtol=0,
                                       atol=0)
    vs = TBd.stack_bundles(tvs)
    np.testing.assert_array_equal(
        vs.d_limit.numpy(), np.asarray(JBd.stack_bundles(jvs).d_limit))
    np.testing.assert_array_equal(vs.n_components.numpy(), [4, 4, 4])
