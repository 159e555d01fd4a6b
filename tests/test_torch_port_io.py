"""The port's synthetic data and data I/O (``ocm_tpu_torch.utils.synthetic``
and ``utils.io``) against ``ocm_tpu``'s, on the CPU.

Synthetic outputs are bit-equal for the same seed; the .mat loaders give
equal arrays on classic (scipy ``savemat``) and MATLAB v7.3 files
(``matlab_fixtures``' layout and ``tests/test_data.py``'s), and the same
errors; an HDF5 object store written by either package reads back equal
in the other; artifact JSON takes tensors.
"""

import numpy as np
import pytest
import scipy.io
import torch

from matlab_fixtures import Cell, Struct, StructArray, write_matlab_v73
from test_data import _write_mat_v73
from ocm_tpu.utils import io as JIO
from ocm_tpu.utils import synthetic as JSY
from ocm_tpu_torch.utils import io as TIO
from ocm_tpu_torch.utils import synthetic as TSY


def _equal_trees(a, b):
    assert type(a) is type(b)
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _equal_trees(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal_trees(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


@pytest.mark.parametrize("name,kwargs", [
    ("cheese_like", dict(seed=3, n_per_class=12, length=40, n_classes=4)),
    ("cheese_like", dict()),
    ("nut_cube", dict(seed=1, nut_idx=2, height=40, width=48, length=24)),
    ("nut_cube", dict(seed=5, height=64, width=64, length=16, n_objects=4,
                      radius_range=(4, 9))),
    ("nut_objects", dict(seed=7, n_objects=3, pixels=11, length=20)),
])
def test_synthetic_bit_equal(name, kwargs):
    _equal_trees(getattr(TSY, name)(**kwargs), getattr(JSY, name)(**kwargs))
    assert (TSY.CHEESE_LENGTH, TSY.NUT_WAVELENGTHS, TSY.NUT_TYPES) == (
        JSY.CHEESE_LENGTH, JSY.NUT_WAVELENGTHS, JSY.NUT_TYPES)


def _cheese_arrays(rng, length=9):
    return (rng.normal(0, 1, (14, length)), rng.integers(1, 4, 14),
            rng.normal(0, 1, (6, length)), rng.integers(1, 4, 6))


def _write_cheese(kind, path, rng):
    x_tr, y_tr, x_ts, y_ts = _cheese_arrays(rng)
    if kind == "v5_cell_class":
        scipy.io.savemat(path, {
            "Xtr": {"data": x_tr, "class": np.array([[y_tr]], dtype=object)},
            "Xts": {"data": x_ts, "class": np.array([[y_ts]], dtype=object)}})
    elif kind == "v5_reordered":
        scipy.io.savemat(path, {
            "Xtr": {"class": y_tr.reshape(-1, 1).astype(float), "data": x_tr},
            "Xts": {"class": y_ts.reshape(-1, 1).astype(float), "data": x_ts}})
    elif kind == "v73_plain_h5":
        _write_mat_v73(path, {
            "Xtr": {"data": x_tr, "class": y_tr.reshape(-1, 1).astype(float)},
            "Xts": {"data": x_ts, "class": y_ts.reshape(-1, 1).astype(float)}})
    elif kind == "v73_struct_array":
        write_matlab_v73(path, {
            "Xtr": StructArray([{"data": x_tr, "class": Cell(
                [y_tr.reshape(-1, 1).astype(float)])}]),
            "Xts": StructArray([{"data": x_ts, "class": Cell(
                [y_ts.reshape(-1, 1).astype(float)])}])})
    else:
        write_matlab_v73(path, {
            "Xtr": Struct({"data": x_tr,
                           "class": y_tr.reshape(-1, 1).astype(float)}),
            "Xts": Struct({"data": x_ts,
                           "class": y_ts.reshape(-1, 1).astype(float)})})
    return x_tr, y_tr, x_ts, y_ts


@pytest.mark.parametrize("kind", ["v5_cell_class", "v5_reordered",
                                  "v73_plain_h5", "v73_struct_array",
                                  "v73_struct"])
def test_load_cheese_mat_equals_jax_package(tmp_path, rng, kind):
    path = str(tmp_path / f"{kind}.mat")
    x_tr, y_tr, x_ts, y_ts = _write_cheese(kind, path, rng)
    got, ref = TIO.load_cheese_mat(path), JIO.load_cheese_mat(path)
    _equal_trees(got, ref)
    for g, w in zip(got, (x_tr, y_tr - 1, x_ts, y_ts - 1)):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(TIO.cheese_wavelengths(501),
                                  JIO.cheese_wavelengths(501))


@pytest.mark.parametrize("case", ["missing_struct", "missing_field",
                                  "not_struct", "count_mismatch"])
def test_load_cheese_mat_errors_match(tmp_path, rng, case):
    x, y = rng.normal(0, 1, (8, 5)), rng.integers(1, 3, 8)
    payload = {
        "missing_struct": {"Xtr": {"data": x, "class": y}},
        "missing_field": {"Xtr": {"data": x, "labels": y},
                          "Xts": {"data": x, "labels": y}},
        "not_struct": {"Xtr": x, "Xts": x},
        "count_mismatch": {"Xtr": {"data": x, "class": y[:5]},
                           "Xts": {"data": x, "class": y}}}[case]
    path = str(tmp_path / f"{case}.mat")
    scipy.io.savemat(path, payload)
    with pytest.raises(ValueError) as ours:
        TIO.load_cheese_mat(path)
    with pytest.raises(ValueError) as theirs:
        JIO.load_cheese_mat(path)
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("kind", ["v5", "v73", "v73_plain_h5"])
def test_load_swir_mat_equals_jax_package(tmp_path, rng, kind):
    fields = {"Almond_img1": rng.normal(1, 0.05, (6, 9, 4)),
              "almond_2": rng.normal(1, 0.05, (5, 7, 4)),
              "walnut_a": rng.normal(2, 0.05, (6, 6, 4)),
              "calibration_panel": rng.normal(0, 1, (3, 3, 4))}
    path = str(tmp_path / "swir.mat")
    if kind == "v73":
        write_matlab_v73(path, {**fields, "label": "peanut"})
    elif kind == "v73_plain_h5":
        _write_mat_v73(path, fields)
    else:
        scipy.io.savemat(path, fields)
    classes = ["nut", "walnut", "almond"]
    got, ref = (m.load_swir_mat(path, classes) for m in (TIO, JIO))
    _equal_trees(got, ref)
    assert len(got[0]["almond"]) == 2 and len(got[0]["walnut"]) == 1


def test_segment_cube_equals_jax_package():
    cube = TSY.nut_cube(seed=4, height=40, width=40, length=12)
    got, ref = TIO.segment_cube(cube, 0.5), JIO.segment_cube(cube, 0.5)
    assert got[1] == ref[1] >= 3
    np.testing.assert_array_equal(got[0], ref[0])


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_object_store_crosses_packages(tmp_path, writer):
    pytest.importorskip("h5py")
    cubes = {"almond": [TSY.nut_cube(seed=s, height=32, width=32, length=6)
                        for s in (1, 2)],
             "peanut": [TSY.nut_cube(seed=3, nut_idx=3, height=32, width=32,
                                     length=6)]}
    data = {cls: [TIO.extract_objects(c, 0.5) for c in imgs]
            for cls, imgs in cubes.items()}
    path = str(tmp_path / "store.h5")
    (TIO if writer == "port" else JIO).write_object_store(path, data)
    got, ref = TIO.read_object_store(path), JIO.read_object_store(path)
    assert list(got) == list(ref) == ["almond", "peanut"]
    for cls in got:
        assert len(got[cls]) == len(ref[cls]) == sum(map(len, data[cls]))
        for a, b in zip(got[cls], ref[cls]):
            assert set(a) == set(b)
            for key in a:
                np.testing.assert_array_equal(a[key], b[key])
    only = TIO.read_object_store(path, classes=["peanut"])
    assert list(only) == ["peanut"] and only["peanut"][0]["nut_type"] == "peanut"


def test_save_json_takes_tensors(tmp_path):
    run = str(tmp_path / "run0")
    payload = {"lr": np.float32(0.001), "epochs": np.int64(10),
               "losses": np.arange(3.0), "nested": {"a": [np.float64(1.5)]},
               "curve": torch.tensor([0.5, 0.25]), "k": torch.tensor(7),
               "matrix": torch.arange(6.0).reshape(2, 3), (1, 2): "tuple key"}
    path = TIO.save_json(payload, run, "params.json")
    assert path.endswith("params.json")
    back = TIO.load_json(run, "params.json")
    assert back["lr"] == pytest.approx(0.001) and back["epochs"] == 10
    assert back["losses"] == [0.0, 1.0, 2.0] and back["nested"]["a"] == [1.5]
    assert back["curve"] == [0.5, 0.25] and back["k"] == 7
    assert back["matrix"] == [[0.0, 1.0, 2.0], [3.0, 4.0, 5.0]]
    # without tensors, the same file as the JAX package writes
    plain = {k: v for k, v in payload.items()
             if not isinstance(v, torch.Tensor)}
    TIO.save_json(plain, run, "a.json")
    JIO.save_json(plain, run, "b.json")
    assert (tmp_path / "run0" / "a.json").read_text() == \
        (tmp_path / "run0" / "b.json").read_text()
