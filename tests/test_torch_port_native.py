"""The port's host C++ core (``ocm_tpu_torch.utils.native``, its own
``csrc/ccl.cpp`` built with g++) against its numpy/scipy twins and
``ocm_tpu.utils.native``, on the CPU.

Every entry point is held bit-equal (``mean_image``: allclose, its numpy
twin sums in f32), ``SIMCAScorer``'s int8 chunks prepared by the native
fused pass are bit-equal to the numpy center-then-quantize prep it
replaced and to JAX's scorer's, and a source that does not compile raises
with the compiler's output.
"""

import jax
import numpy as np
import pytest
import torch
from scipy import ndimage

from ocm_tpu.serving import SIMCAScorer as JScorer
from ocm_tpu.utils import native as JN
from ocm_tpu_torch.ops import linalg as TL
from ocm_tpu_torch.serving import SIMCAScorer
from ocm_tpu_torch.utils import io as TIO
from ocm_tpu_torch.utils import native as TN
from torch_port_data import LENGTH, make_data, simca_classes_pair


@pytest.fixture
def cube(rng):
    c = rng.normal(0.02, 0.01, (48, 64, 16)).astype(np.float32)
    yy, xx = np.mgrid[:48, :64]
    for cy, cx, r, v in [(10, 10, 4, 1.0), (30, 40, 6, 2.0), (44, 60, 2, 1.5),
                         (10, 18, 3, 1.2), (0, 0, 1, 3.0)]:
        mask = (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r
        c[mask] += v
    return c


def test_mean_image_matches_numpy_and_jax_package(cube):
    got = TN.mean_image(cube)
    assert got.dtype == np.float32 and got.shape == cube.shape[:2]
    np.testing.assert_array_equal(got, JN.mean_image(cube))
    np.testing.assert_allclose(got, TN.mean_image_plain(cube), rtol=1e-6)


@pytest.mark.parametrize("trial", range(4))
def test_label_identical_to_scipy(rng, trial):
    for density in (0.2, 0.35, 0.5, 0.65, 0.8):
        mask = rng.random((37 + trial, 53)) < density
        ours, n_ours = TN.label(mask)
        theirs, n_theirs = ndimage.label(mask, structure=np.ones((3, 3), int))
        plain, n_plain = TN.label_plain(mask)
        assert n_ours == n_theirs == n_plain
        assert ours.dtype == np.int32
        np.testing.assert_array_equal(ours, theirs)
        np.testing.assert_array_equal(ours, plain)
        np.testing.assert_array_equal(ours, JN.label(mask)[0])


def test_label_edge_cases():
    cases = {"empty": np.zeros((5, 5), bool), "full": np.ones((5, 5), bool),
             "diagonal": np.eye(6, dtype=bool),
             "anti_diagonal": np.eye(6, dtype=bool)[::-1].copy(),
             "row": np.ones((1, 9), bool), "column": np.ones((9, 1), bool),
             "single": np.ones((1, 1), bool),
             "checker": (np.add.outer(np.arange(7), np.arange(8)) % 2) == 0,
             "u_shape": np.array([[1, 0, 1], [1, 0, 1], [1, 1, 1]], bool)}
    want_n = {"empty": 0, "full": 1, "diagonal": 1, "anti_diagonal": 1,
              "row": 1, "column": 1, "single": 1, "checker": 1, "u_shape": 1}
    for name, mask in cases.items():
        ours, n = TN.label(mask)
        theirs, n_t = ndimage.label(mask, structure=np.ones((3, 3), int))
        assert n == n_t == want_n[name], name
        np.testing.assert_array_equal(ours, theirs, err_msg=name)


def test_gather_and_sizes_match_twins_and_jax_package(cube):
    labels, n = TN.label(cube.mean(axis=2) >= 0.5)
    sizes = TN.object_sizes(labels, n)
    np.testing.assert_array_equal(sizes, TN.object_sizes_plain(labels, n))
    np.testing.assert_array_equal(sizes, JN.object_sizes(labels, n))
    assert sizes.sum() == (labels > 0).sum()
    for obj in range(1, n + 1):
        spectra, coords = TN.gather_object(cube, labels, obj)
        want = TN.gather_object_plain(cube, labels, obj)
        ref = JN.gather_object(cube, labels, obj)
        for got, w, r in zip((spectra, coords), want, ref):
            np.testing.assert_array_equal(got, w)
            np.testing.assert_array_equal(got, r)
    with pytest.raises(ValueError, match="pixels"):
        TN.gather_object(cube, labels, 1, n_pixels=int(sizes[0]) + 1)


@pytest.mark.parametrize("as_counts", [False, True], ids=["f32", "uint16"])
def test_extract_objects_native_equals_scipy_route_and_jax(cube, as_counts):
    thr = 0.5
    if as_counts:
        cube = np.clip(np.round(cube * 1e4), 0, 65535).astype(np.uint16)
        thr = 0.5e4
    ours = TN.extract_objects_native(cube, thr, min_pixels=2)
    scipy_route = TIO.extract_objects(cube, thr, min_pixels=2)
    ref = JN.extract_objects_native(cube, thr, min_pixels=2)
    assert len(ours) == len(scipy_route) == len(ref) >= 4
    for a, b, r in zip(ours, scipy_route, ref):
        for key in ("n_pixels", "obj_idx", "centroid"):
            assert a[key] == b[key] == r[key], key
        for key in ("spectral_data", "mean_spectrum"):
            np.testing.assert_array_equal(a[key], b[key])
            np.testing.assert_array_equal(a[key], r[key])


def _rows(rng, n, length):
    x = (rng.normal(0, 3.0, (n, length)) * 10.0 ** rng.integers(
        -2, 3, (n, 1))).astype(np.float32)
    x[0] = 0.0                            # all-zero row: scale floor, q = 0
    x[1] = 0.0
    x[1, :4] = [2.5, 3.5, -2.5, 127.0]    # exact halves at scale 1.0
    x[2] = np.float32(1e17) * np.sign(x[2])     # extremes, finite sumsq
    x[3, ::2] = -np.float32(1e-38)        # tiny magnitudes
    return x


@pytest.mark.parametrize("length", [129, 203, 288, 7])
@pytest.mark.parametrize("centered", [False, True])
def test_quantize_rows_int8_bit_equal(rng, length, centered):
    x = _rows(rng, 257, length)
    center = rng.normal(0.5, 2.0, length).astype(np.float32) if centered \
        else None
    got = TN.quantize_rows_int8(x, center=center)
    want = TN.quantize_rows_int8_plain(x, center=center)
    ref = JN.quantize_rows_int8(x, center=center)
    for g, w, r, name, dt in zip(got, want, ref, ("q", "scale", "sumsq"),
                                 (np.int8, np.float32, np.float32)):
        assert g.dtype == dt, name
        np.testing.assert_array_equal(g, w, err_msg=name)
        np.testing.assert_array_equal(g, r, err_msg=name)
    if not centered:
        np.testing.assert_array_equal(got[0][1, :4], [2, 4, -2, 127])
        assert np.all(got[0][0] == 0) and got[2][0] == 0


def test_linalg_quantize_numpy_goes_native(rng):
    x = _rows(rng, 40, 33)
    for a in (x, x.astype(np.float64), x.reshape(4, 10, 33)):
        got = TL.quantize_rows_int8(a)
        want = TN.quantize_rows_int8_plain(a)
        for g, w in zip(got, want):
            assert isinstance(g, np.ndarray)
            np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="center"):
        TN.quantize_rows_int8(x, center=np.zeros(5, np.float32))


def test_int8_scorer_prepared_chunks_bit_equal_to_numpy_prep_and_jax():
    """The scorer's int8 chunks: one native fused center + quantize pass,
    bit-equal to the numpy prep it replaced (center, then quantize) and to
    the JAX package's scorer's chunks."""
    cals, xs = make_data(seed=3)
    ref, port = simca_classes_pair(cals.reshape(-1, LENGTH).astype(np.float32))
    x = xs.astype(np.float32)
    scorer = SIMCAScorer(port, chunk_size=128, store_dtype=torch.int8)
    jscorer = JScorer(ref, chunk_size=128, store_dtype=jax.numpy.int8)
    prepared, jprepared = scorer.prepare(x), jscorer.prepare(x)
    assert len(prepared) == len(jprepared) == 4
    for i, ((args, n), (jargs, jn)) in enumerate(zip(prepared, jprepared)):
        chunk = x[i * 128:(i + 1) * 128]
        padded = np.concatenate([chunk, np.repeat(chunk[-1:],
                                                  128 - len(chunk), 0)])
        want = TN.quantize_rows_int8_plain(padded - scorer.center[None, :])
        assert n == jn == len(chunk)
        for got, w, j in zip(args, want, jargs):
            np.testing.assert_array_equal(got.numpy(), w)
            np.testing.assert_array_equal(got.numpy(), np.asarray(j))


def test_broken_source_raises_with_compiler_output(tmp_path):
    src = tmp_path / "broken.cpp"
    src.write_text('extern "C" int f() { return undefined_name; }\n')
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as err:
        TN.build(src, build_dir=tmp_path)
    assert "undefined_name" in str(err.value)
    assert not list(tmp_path.glob("*.so"))
    good = tmp_path / "good.cpp"
    good.write_text('extern "C" int f() { return 3; }\n')
    lib = TN.build(good, build_dir=tmp_path)
    assert lib == TN.library_path(good, tmp_path) and lib.exists()
    assert TN.build(good, build_dir=tmp_path) == lib      # built once


def test_library_is_built_in_the_package_by_source_hash():
    path = TN.library_path()
    assert path.parent.name == "_build"
    assert path.parent.parent.name == "ocm_tpu_torch"
    assert path.name.startswith("libocm_ccl_") and path.suffix == ".so"
    assert TN.available() and TN.library()._name == str(TN.build())
    assert 1 <= TN.threads_for(1) <= TN.threads_for(1 << 30)
