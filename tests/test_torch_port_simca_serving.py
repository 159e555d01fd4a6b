"""The port's ``SIMCAScorer`` and bf16 ``VAEScorer`` twin
(``ocm_tpu_torch.serving``) against ``ocm_tpu.serving``, on the CPU.

Both scorers hold the same models: JAX's ``fit_classes`` of three f32
classes, carried into the port. 500 spectra in chunks of 128 leave a
ragged tail. The contracts are the JAX package's own
(``tests/test_serving.py``):
- f32: ``dred`` within 1e-4 relative (the port's kernel centers
  directly, JAX expands Q), accepts equal on >= 99.9 %;
- bf16, int8 and raw uint16 ingest: accepts >= 99.5 % of the f32 scorer's
  and of JAX's same mode, ``dred`` within 3e-2 of its maximum; the int8
  product is exact in both packages on bit-equal quantized chunks, so
  int8 also agrees with JAX's int8 scorer to 1e-5 of scale;
- prepared, prefetched and streamed screens equal ``score`` bit for bit;
- bf16 VAE twin: accepts >= 98 % of JAX's bf16 twin, statistics f32.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from ocm_tpu.models import vae_decision as JD
from ocm_tpu.models import vaesimca as JV
from ocm_tpu.ops.preprocess import snv_savgol as jax_snv_savgol
from ocm_tpu.serving import SIMCAScorer as JScorer
from ocm_tpu.serving import VAEScorer as JVAEScorer
from ocm_tpu_torch.models import bundle as TBd
from ocm_tpu_torch.models import vaesimca as TV
from ocm_tpu_torch.ops.preprocess import snv_savgol
from ocm_tpu_torch.serving import SIMCAScorer, VAEScorer
from oracles import make_class_spectra
from torch_port_data import (LENGTH, bundle_as_numpy, counts_u16, make_data,
                             simca_classes_pair, vae_bundle_pair, vae_classes)

CHUNK = 128
MODES = {"f32": None, "bf16": torch.bfloat16, "int8": torch.int8}
JAX_MODES = {"f32": None, "bf16": jnp.bfloat16, "int8": jnp.int8}


def _prep(x):
    return snv_savgol(x, 5, 2, 1)


def _jax_prep(x):
    return jax_snv_savgol(x, 5, 2, 1)


@pytest.fixture(scope="module")
def data():
    """(JAX models, port models, screened spectra f32, and the same for
    raw ingest: models fitted on SNV+SavGol of camera counts, counts)."""
    cals, xs = make_data(seed=2)
    cal = cals.reshape(-1, LENGTH)
    ref, port = simca_classes_pair(cal.astype(np.float32))
    raw_cal = _prep(torch.from_numpy(counts_u16(cal)).to(torch.float32))
    raw_ref, raw_port = simca_classes_pair(raw_cal.numpy())
    return ref, port, xs.astype(np.float32), raw_ref, raw_port, counts_u16(xs)


def _one(models, c=0):
    return jax.tree.map(lambda a: a[c], models)


def _agree(got, ref, floor, dred_atol=3e-2):
    assert got["accept"].shape == ref["accept"].shape
    agree = np.mean(got["accept"] == ref["accept"])
    assert agree >= floor, agree
    np.testing.assert_allclose(
        got["dred"], ref["dred"], rtol=0,
        atol=dred_atol * float(np.abs(ref["dred"]).max()))


@pytest.mark.parametrize("stacked", [True, False], ids=["stacked", "single"])
def test_f32_scorer_matches_jax(data, stacked):
    ref, port, xs, *_ = data
    if not stacked:
        ref, port = _one(ref), _one(port)
    got = SIMCAScorer(port, chunk_size=CHUNK).score(xs)
    want = JScorer(ref, chunk_size=CHUNK).score(xs)
    assert set(got) == {"accept", "dred", "t2", "q"}
    assert got["accept"].shape == ((len(xs), 3) if stacked else (len(xs),))
    assert got["dred"].dtype == np.float32
    assert np.mean(got["accept"] == np.asarray(want["accept"])) >= 0.999
    np.testing.assert_allclose(got["dred"], want["dred"], rtol=1e-4,
                               atol=1e-6 * np.abs(want["dred"]).max())
    assert 0.1 < got["accept"].mean() < 0.6


@pytest.fixture(scope="module")
def jax_recipe():
    """The JAX package's own bf16 serving data (``tests/test_serving.py``'s
    ``stacked_models``): three classes of 80 x 48, k 5, screened on
    themselves; JAX models and the port's carried copy."""
    rng = np.random.default_rng(7)
    x = np.concatenate([make_class_spectra(rng, 80, 48, center_shift=0.6 * c)
                        for c in range(3)]).astype(np.float32)
    return (*simca_classes_pair(x, k=5), x)


def _reduced_vs_jax(port, ref, x, mode):
    got = SIMCAScorer(port, chunk_size=96, store_dtype=MODES[mode]).score(x)
    want = JScorer(ref, chunk_size=96, store_dtype=JAX_MODES[mode]).score(x)
    return got, {k: np.asarray(v) for k, v in want.items()}


@pytest.mark.parametrize("mode", ["bf16", "int8"])
@pytest.mark.parametrize("stacked", [True, False], ids=["stacked", "single"])
def test_reduced_width_scorers_match_f32_and_jax(data, jax_recipe, mode,
                                                 stacked):
    """Against the port's f32 scorer on the port's data, and against JAX's
    scorer of the same width on the JAX package's own test data. On the
    port's data JAX's bf16 scorer misses its own contract (class 0 agrees
    with JAX's f32 on 77 % of spectra): it casts means and loadings to bf16
    and expands Q, where K1 keeps them f32 and centers directly."""
    ref, port, xs, *_ = data
    jref, jport, jx = jax_recipe
    if not stacked:
        ref, port, jref, jport = (_one(m) for m in (ref, port, jref, jport))
    got = SIMCAScorer(port, chunk_size=CHUNK,
                      store_dtype=MODES[mode]).score(xs)
    f32 = SIMCAScorer(port, chunk_size=CHUNK).score(xs)
    _agree(got, f32, 0.995)
    assert all(v.dtype == np.float32 for k, v in got.items() if k != "accept")
    _agree(*_reduced_vs_jax(jport, jref, jx, mode), 0.995)
    if mode == "int8":
        want = JScorer(ref, chunk_size=CHUNK, store_dtype=jnp.int8).score(xs)
        _agree(got, {k: np.asarray(v) for k, v in want.items()}, 0.999,
               dred_atol=1e-5)


def test_single_class_equals_stacked_column(data):
    _, port, xs, *_ = data
    stacked = SIMCAScorer(port, chunk_size=CHUNK)
    out = stacked.score(xs)
    for c in range(3):
        single = SIMCAScorer(_one(port, c), chunk_size=CHUNK,
                             center=stacked.center).score(xs)
        np.testing.assert_array_equal(out["accept"][:, c], single["accept"])
        np.testing.assert_allclose(out["dred"][:, c], single["dred"],
                                   rtol=1e-6)


def test_host_bf16_cast_equals_ml_dtypes():
    """The scorer casts residuals to bf16 on the host with torch (the
    card's machine has no ml_dtypes): round to nearest, ties to even."""
    rng = np.random.default_rng(0)
    a = (rng.normal(0, 1, 4096) * 10.0 ** rng.integers(-40, 38, 4096)
         ).astype(np.float32)
    bits = rng.integers(0, 2 ** 32, 4096, dtype=np.uint64).astype(np.uint32)
    ties = (bits & np.uint32(0xFFFF0000)) | np.uint32(0x8000)  # exact ties
    special = np.array([0.0, -0.0, np.inf, -np.inf, 1e-45, 3.4e38, 1.0,
                        1.00390625, 1.01171875], np.float32)
    for x in (a, bits.view(np.float32), ties.view(np.float32), special):
        x = x[np.isfinite(x) | np.isinf(x)]
        got = torch.from_numpy(x).to(torch.bfloat16).view(torch.int16)
        want = x.astype(ml_dtypes.bfloat16).view(np.int16)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("stacked", [True, False], ids=["stacked", "single"])
def test_raw_u16_ingest_matches_host_prep_and_jax(data, stacked):
    *_, raw_ref, raw_port, counts = data
    if not stacked:
        raw_ref, raw_port = _one(raw_ref, 1), _one(raw_port, 1)
    got = SIMCAScorer(raw_port, chunk_size=CHUNK,
                      preprocess_fn=_prep).score(counts)
    host = SIMCAScorer(raw_port, chunk_size=CHUNK).score(
        _prep(torch.from_numpy(counts).to(torch.float32)).numpy())
    want = JScorer(raw_ref, chunk_size=CHUNK,
                   preprocess_fn=_jax_prep).score(counts)
    want = {k: np.asarray(v) for k, v in want.items()}
    assert np.mean(got["accept"] == host["accept"]) >= 0.999
    np.testing.assert_allclose(got["dred"], host["dred"], rtol=1e-4,
                               atol=1e-6 * np.abs(host["dred"]).max())
    _agree(got, want, 0.995)
    assert 0.1 < got["accept"].mean() < 0.6


@pytest.mark.parametrize("mode", ["f32", "bf16", "int8", "raw"])
def test_prepare_prefetch_and_stream_equal_score(data, mode):
    _, port, xs, _, raw_port, counts = data
    if mode == "raw":
        scorer = SIMCAScorer(raw_port, chunk_size=CHUNK, preprocess_fn=_prep)
        x = counts
    else:
        scorer = SIMCAScorer(port, chunk_size=CHUNK, store_dtype=MODES[mode])
        x = xs
    ref = scorer.score(x)
    prepared = scorer.prepare(x)
    assert len(prepared) == 4 and prepared[-1][1] == len(x) - 3 * CHUNK
    for out in (scorer.score_prepared(prepared),
                scorer.score_prepared(prepared), scorer.score(x, prefetch=0),
                scorer.score(x, prefetch=3)):
        for k in ref:
            np.testing.assert_array_equal(out[k], ref[k], err_msg=k)
    frames = list(scorer.score_stream([x[:70], x[70:300], x[300:]]))
    for k in ref:
        np.testing.assert_array_equal(
            np.concatenate([f[k] for f in frames]), ref[k], err_msg=k)
    assert scorer.score(x[:0]) == {} and scorer.score_prepared([]) == {}


@pytest.mark.parametrize("mode", ["f32", "bf16", "int8"])
def test_rescreen_prepared_chunks_with_updated_models(data, mode):
    """Chunks prepared by one scorer re-screen against updated models built
    with ``center=old.center``: equal to the new models' own screen at that
    center, and close to their screen at their own center."""
    _, port, xs, *_ = data
    cals, _ = make_data(seed=2)
    rng = np.random.default_rng(17)
    cal = cals.reshape(-1, LENGTH) + rng.normal(0, 0.01, (360, LENGTH))
    _, updated = simca_classes_pair(cal.astype(np.float32), k=6)
    old = SIMCAScorer(port, chunk_size=CHUNK, store_dtype=MODES[mode])
    prepared = old.prepare(xs)
    renew = SIMCAScorer(updated, chunk_size=CHUNK, store_dtype=MODES[mode],
                        center=old.center)
    out = renew.score_prepared(prepared)
    same = renew.score(xs)
    for k in out:
        np.testing.assert_array_equal(out[k], same[k], err_msg=k)
    own = SIMCAScorer(updated, chunk_size=CHUNK,
                      store_dtype=MODES[mode]).score(xs)
    assert np.mean(out["accept"] == own["accept"]) >= (
        0.999 if mode == "f32" else 0.995)
    assert not np.array_equal(old.center, renew.center - 1.0)
    np.testing.assert_array_equal(renew.center, old.center)


def test_single_class_center_pinning(data):
    _, port, xs, *_ = data
    m0 = _one(port)
    assert SIMCAScorer(m0).center is None
    np.testing.assert_array_equal(
        SIMCAScorer(m0, store_dtype=torch.int8).center, m0.mean.numpy())
    mu = port.mean.mean(0).numpy()
    out = SIMCAScorer(m0, chunk_size=CHUNK, center=mu).score(xs)
    ref = SIMCAScorer(m0, chunk_size=CHUNK).score(xs)
    np.testing.assert_array_equal(out["accept"], ref["accept"])
    np.testing.assert_allclose(out["dred"], ref["dred"], rtol=1e-4,
                               atol=1e-5)


def test_scorer_validation_errors(data):
    _, port, *_, raw_port, _ = data
    with pytest.raises(ValueError, match="bfloat16"):
        SIMCAScorer(port, store_dtype=torch.float16)
    for dt in (torch.int8, torch.bfloat16):
        with pytest.raises(ValueError, match="mutually exclusive"):
            SIMCAScorer(raw_port, preprocess_fn=_prep, store_dtype=dt)
    with pytest.raises(ValueError, match="re-screening"):
        SIMCAScorer(_one(raw_port), preprocess_fn=_prep,
                    center=np.zeros(LENGTH, np.float32))
    with pytest.raises(ValueError, match="center must be"):
        SIMCAScorer(port, center=np.zeros(LENGTH + 1, np.float32))
    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
        SIMCAScorer(port, mesh=object())


# --- the bf16 VAEScorer twin ------------------------------------------------

def _f32(tree):
    """A port bundle or VAE-SIMCA model with its float leaves in f32."""
    def conv(t):
        return t.float() if t.is_floating_point() else t

    fields = {f: conv(getattr(tree, f)) for f in tree._fields
              if f != "state_dict"}
    if "state_dict" in tree._fields:
        fields["state_dict"] = {k: conv(v) for k, v in tree.state_dict.items()}
    return type(tree)(**fields)


@pytest.fixture(scope="module")
def vae_class():
    (x_cal,), x_test = vae_classes(1, n_cal=60, n_test_per=60)
    jm, jb, tm, _ = vae_bundle_pair(x_cal, key=10, bn_seed=5)
    jb = JD.fit_thresholds(jm, jb, x_cal, loss_type="euclidean")
    jv = JV.fit_vaesimca(jm, jb, x_cal)
    tb = _f32(TBd.ocm_bundle_from_numpy(bundle_as_numpy(jb), tm, device="cpu"))
    tv = _f32(TV.vaesimca_model_from_numpy(bundle_as_numpy(jv), device="cpu"))
    return jm, jb, jv, tm.float(), tb, tv, x_test.astype(np.float32)


@pytest.mark.parametrize("variant", ["d2", "vaesimca"])
def test_vae_bf16_twin_matches_jax_twin(vae_class, variant):
    jm, jb, jv, tm, tb, tv, x = vae_class
    kw = dict(variant=variant, loss_type="euclidean", chunk_size=48)
    got = VAEScorer(tm, tb, compute_dtype=torch.bfloat16,
                    vaesimca_model=tv if variant == "vaesimca" else None,
                    **kw).score(x)
    f32 = VAEScorer(tm, tb, vaesimca_model=tv if variant == "vaesimca"
                    else None, **kw).score(x)
    want = JVAEScorer(jm, jb, compute_dtype=jnp.bfloat16,
                      vaesimca_model=jv if variant == "vaesimca" else None,
                      **kw).score(x)
    assert set(got) == set(want) == set(f32)
    assert all(v.dtype == np.float32 for k, v in got.items() if k != "accept")
    assert np.mean(got["accept"] == np.asarray(want["accept"])) >= 0.98
    assert np.mean(got["accept"] == f32["accept"]) >= 0.98
    assert 0 < got["accept"].mean() < 1
    # the network really ran in bf16: statistics move off the f32 ones
    key = "d2" if variant == "d2" else "t2"
    assert not np.array_equal(got[key], f32[key])


def test_vae_bf16_twin_validation(vae_class):
    *_, tm, tb, _, _ = vae_class
    with pytest.raises(ValueError, match="bfloat16"):
        VAEScorer(tm, tb, compute_dtype=torch.float16)
    with pytest.raises(ValueError, match="float32"):
        VAEScorer(tm.double(), _f64(tb), compute_dtype=torch.bfloat16)


def _f64(tree):
    fields = {f: getattr(tree, f).double() for f in tree._fields
              if f != "state_dict"}
    fields["state_dict"] = {k: v.double() if v.is_floating_point() else v
                            for k, v in tree.state_dict.items()}
    return type(tree)(**fields)
