"""Data ingest and experiment-artifact I/O (port of ``ocm_tpu/utils/io.py``).

Covers the reference's data layer:

- cheese FTIR .mat structs: ``Xtr``/``Xts`` struct arrays with ``data`` and
  ``class`` fields, labels shifted to 0-based (``data_cheese.py:22-45``,
  ``simca_new_cheese.py:12-25``), classic and MATLAB v7.3 (HDF5) files;
- SWIR hyperspectral cubes -> per-object pixel spectra: background masking by
  mean intensity, 8-connected component labeling, per-object extraction
  (``nut_data.py:65-71,131-160``), by scipy here and by the native core in
  ``utils.native.extract_objects_native``;
- the HDF5 object store schema ``<class>/img_<i>/obj_<j>/spectra`` with
  n_pixels/centroid/img_idx/... attrs (``nut_data.py:146-185``), reader shaped
  like the consumer in ``vae_bce_nut.py:65-76``; a store written by either
  package reads back equal in the other;
- per-run artifact JSONs: params.json / losses.json / metrics.json
  (``utils/final_vaesimca.py:316-322,449,593-604``), taking numpy arrays,
  numpy scalars and torch tensors.

h5py and scipy are imported lazily, as the reference does: nothing on the
card's path needs them.
"""

from __future__ import annotations

import json
import os
from typing import Mapping, Optional

import numpy as np
import torch


# ---------------------------------------------------------------------------
# Cheese FTIR (.mat)
# ---------------------------------------------------------------------------

def _struct_fields(struct, key: str) -> dict:
    """MATLAB struct -> {field: value}, accessed BY NAME (robust to field
    re-ordering; the reference maps by enumeration order,
    data_cheese.py:33-34).  v7.3 structs arrive as plain dicts from the
    h5py fallback reader and pass through unchanged."""
    if isinstance(struct, dict):
        return struct
    struct = np.asarray(struct)
    if struct.dtype.names is None:
        raise ValueError(
            f"{key!r}: expected a MATLAB struct with named fields, got "
            f"array of dtype {struct.dtype} and shape {struct.shape}")
    rec = struct.reshape(-1)[0]
    return {name: rec[name] for name in struct.dtype.names}


def _unwrap_cell(value):
    """Strip MATLAB cell/object nesting: loadmat wraps nested containers in
    object arrays — as a (1, 1) singleton for one nested array, or
    element-wise (one cell per scalar, e.g. shape (1, 1, n)) for cell
    vectors."""
    value = np.asarray(value)
    while value.dtype == object:
        if value.size == 1:
            value = np.asarray(value.reshape(-1)[0])
        else:
            elems = [np.squeeze(_unwrap_cell(e)) for e in value.reshape(-1)]
            shapes = sorted({np.shape(e) for e in elems})
            if len(shapes) > 1:
                raise ValueError(
                    "ragged MATLAB cell array: elements have mismatched "
                    f"shapes {shapes[:4]}{'...' if len(shapes) > 4 else ''} "
                    "— this loader expects rectangular cell contents")
            value = np.stack(elems)
    return value


def _h5_read(node, file):
    """One HDF5 node of a MATLAB v7.3 file -> numpy/dict/str.

    MATLAB writes arrays column-major, so every dataset's axes arrive
    reversed (``.T`` restores MATLAB orientation); structs are HDF5
    groups; cell arrays are object-reference datasets, dereferenced
    element-wise (a single-element cell unwraps to its content, matching
    what ``_unwrap_cell`` does on the classic-format path; ragged cells
    come back as an object array rather than an opaque np.stack shape
    error); char arrays are stored as uint16 code units
    (``MATLAB_int_decode=2``) and are decoded to Python strings; logicals
    are stored as uint8 (``MATLAB_int_decode=1``) and decode to bool;
    empty arrays are stored as their DIMS vector with a ``MATLAB_empty``
    attribute and decode to a size-0 array, not a bogus dims-valued one."""
    import h5py

    if isinstance(node, h5py.Group):
        return {k: _h5_read(v, file) for k, v in node.items()}
    data = node[()]
    mat_class = node.attrs.get("MATLAB_class", b"")
    if isinstance(mat_class, bytes):
        mat_class = mat_class.decode("ascii", "replace")
    if node.attrs.get("MATLAB_empty"):
        # the dataset payload is the MATLAB dims vector, e.g. [0, 3]
        dims = tuple(int(d) for d in np.ravel(data))
        return np.empty(dims, dtype=np.float64 if mat_class != "char"
                        else np.dtype("U1"))
    if mat_class == "char":
        rows = np.atleast_2d(np.asarray(data).T)
        strings = ["".join(map(chr, row)) for row in rows.astype(np.uint32)]
        return strings[0] if len(strings) == 1 else np.asarray(strings)
    if isinstance(data, np.ndarray) and data.dtype.kind == "O":
        # cell array: dereference each element through the file
        items = [_h5_read(file[ref], file) for ref in data.reshape(-1)]
        if len(items) == 1:
            # {x} unwraps to x — same result the classic path reaches via
            # loadmat's (1, 1) object array + _unwrap_cell (real MATLAB
            # struct fields often arrive with this one-level indirection)
            return items[0]
        vals = [np.squeeze(np.asarray(e)) if isinstance(e, np.ndarray)
                else e for e in items]
        if (vals and all(isinstance(v, np.ndarray) for v in vals)
                and len({v.shape for v in vals}) == 1):
            return np.stack(vals)
        out = np.empty(len(vals), dtype=object)   # ragged / mixed cell
        out[:] = vals
        return out
    out = np.asarray(data).T
    if mat_class == "logical":
        out = out.astype(bool)
    return out


def _loadmat(path: str) -> dict:
    """scipy.io.loadmat with a MATLAB v7.3 (HDF5) fallback.

    scipy rejects v7.3 files with NotImplementedError (the format is
    HDF5, not the classic .mat container); those route through h5py with
    structs as dicts and axes restored to MATLAB orientation — the same
    validated schema path serves both formats
    (tests/test_data.py::test_load_cheese_mat_v73)."""
    import scipy.io

    try:
        return scipy.io.loadmat(path)
    except NotImplementedError:
        try:
            import h5py
        except ImportError as e:
            raise NotImplementedError(
                f"{path} is a MATLAB v7.3 file and h5py is not "
                "installed") from e
        with h5py.File(path, "r") as f:
            return {k: _h5_read(v, f) for k, v in f.items()
                    if not k.startswith("#")}


def load_cheese_mat(path: str, data_field: str = "data",
                    class_field: str = "class"):
    """-> (x_train, y_train, x_test, y_test); labels 0-based ints
    (data_cheese.py:22-45).

    Struct fields are accessed by name, cell nesting is unwrapped, and the
    schema is validated with clear errors (field names, label/sample-count
    agreement); a scipy.io.savemat round trip of the reference-shaped
    struct loads identically (tests/test_data.py).  MATLAB v7.3 files
    (HDF5) load through the h5py fallback with the same schema checks."""
    raw = _loadmat(path)
    out = []
    for key in ("Xtr", "Xts"):
        if key not in raw:
            present = [k for k in raw if not k.startswith("__")]
            raise ValueError(f"{path}: missing struct {key!r}; file "
                             f"contains {present}")
        fields = _struct_fields(raw[key], key)
        for f in (data_field, class_field):
            if f not in fields:
                raise ValueError(f"{key!r} has no field {f!r}; fields are "
                                 f"{sorted(fields)}")
        x = np.asarray(_unwrap_cell(fields[data_field]), dtype=np.float64)
        y = np.squeeze(_unwrap_cell(fields[class_field])).astype(int) - 1
        if x.ndim != 2:
            raise ValueError(f"{key}.{data_field}: expected (n_samples, "
                             f"n_wavelengths), got shape {x.shape}")
        if y.ndim != 1 or y.shape[0] != x.shape[0]:
            raise ValueError(
                f"{key}.{class_field}: expected {x.shape[0]} labels, got "
                f"shape {np.shape(y)}")
        out += [x, y]
    return tuple(out)


def load_swir_mat(path: str, classes, dtype=np.float32):
    """SWIR hyperspectral .mat -> {class: [cube, ...]} (nut_data.py:16-60).

    The reference file is a flat dict of ``field_name -> (H, W, L)`` cube
    with the nut type inferred by substring match of the field name
    against the class list; unmatched fields are skipped with a warning
    entry in the returned ``skipped`` list: returns (cubes, skipped).
    MATLAB v7.3 files (HDF5) load through the h5py fallback.

    Substring matching tries the LONGEST class names first, so a class
    that contains another as a substring (e.g. 'walnut' vs 'nut') claims
    its fields before the shorter name can shadow it.

    Non-numeric fields — description strings, metadata structs, cell
    arrays — are routed to ``skipped`` instead of crashing the float
    conversion (real MATLAB acquisition files carry these alongside the
    cubes; the reference's own field-print loop at nut_data.py:22-25
    shows the file is a grab-bag).
    """
    raw = _loadmat(path)
    cubes = {cls: [] for cls in classes}
    by_len = sorted(classes, key=len, reverse=True)
    skipped = []
    for field_name, value in raw.items():
        if field_name.startswith("__"):
            continue
        if (isinstance(value, (str, dict))
                or (isinstance(value, np.ndarray)
                    and (value.dtype.kind in "OUSV"
                         or value.dtype.names is not None))):
            skipped.append(field_name)
            continue
        cube = np.asarray(value, dtype=dtype)
        cls = next((c for c in by_len
                    if c.lower() in field_name.lower()), None)
        if cls is None:
            skipped.append(field_name)
            continue
        if cube.ndim != 3:
            raise ValueError(f"{field_name}: expected an (H, W, L) cube, "
                             f"got shape {cube.shape}")
        cubes[cls].append(cube)
    if not any(cubes.values()):
        raise ValueError(f"{path}: no field matched any class in "
                         f"{list(classes)}; fields were "
                         f"{[k for k in raw if not k.startswith('__')]}")
    return cubes, skipped


def cheese_wavelengths(n: int):
    """FTIR axis 2500-4000 cm^-1 (data_cheese.py:53)."""
    return np.linspace(2500.0, 4000.0, n)


# ---------------------------------------------------------------------------
# HSI object extraction (nut_data.py)
# ---------------------------------------------------------------------------

def segment_cube(cube, background_threshold: float):
    """Background mask + 8-connected labeling of one (H, W, L) cube
    (nut_data.py:65-71).  Returns (labeled (H, W) int array, n_objects)."""
    from scipy import ndimage

    cube = np.asarray(cube)
    foreground = np.mean(cube, axis=2) >= background_threshold
    return ndimage.label(foreground, structure=np.ones((3, 3), dtype=int))


def extract_objects(cube, background_threshold: float,
                    min_pixels: int = 1):
    """Segment one hyperspectral cube (H, W, L) into per-object spectra.

    Background = mean intensity over wavelengths below the threshold
    (nut_data.py:65-66); objects = 8-connected components of the foreground
    (nut_data.py:69-71).  Returns a list of dicts with 'spectral_data'
    (n_pixels, L), 'mean_spectrum', 'centroid', 'n_pixels'.
    """
    cube = np.asarray(cube)
    labeled, n_objects = segment_cube(cube, background_threshold)
    objects = []
    for obj_idx in range(1, n_objects + 1):
        mask = labeled == obj_idx
        n_pixels = int(mask.sum())
        if n_pixels < min_pixels:
            continue
        spectra = np.ascontiguousarray(cube[mask], dtype=np.float32)
        coords = np.argwhere(mask)
        objects.append({
            "spectral_data": spectra,
            "mean_spectrum": spectra.mean(axis=0),
            "centroid": tuple(np.mean(coords, axis=0).tolist()),
            "n_pixels": n_pixels,
            "obj_idx": obj_idx,
        })
    return objects


def write_object_store(path: str, data: Mapping[str, list],
                       compression: Optional[str] = "gzip") -> None:
    """Write the HDF5 schema ``<class>/img_<i>/obj_<j>/spectra``
    (nut_data.py:146-185).  ``data`` maps class -> list of images, each a
    list of object dicts from ``extract_objects``."""
    import h5py

    with h5py.File(path, "w") as h5f:
        for cls, images in data.items():
            for img_idx, objects in enumerate(images):
                for obj in objects:
                    grp = h5f.require_group(
                        f"{cls}/img_{img_idx}/obj_{obj['obj_idx']}")
                    spec = np.ascontiguousarray(obj["spectral_data"],
                                                dtype=np.float32)
                    kw = {"compression": compression,
                          "compression_opts": 4} if compression else {}
                    grp.create_dataset("spectra", data=spec, **kw)
                    grp.attrs["n_pixels"] = int(spec.shape[0])
                    grp.attrs["centroid"] = obj["centroid"]
                    grp.attrs["img_idx"] = img_idx
                    grp.attrs["nut_type"] = cls
                    grp.attrs["obj_idx"] = int(obj["obj_idx"])
                    grp.attrs["mean_spectrum"] = np.asarray(
                        obj["mean_spectrum"], dtype=np.float32)


def read_object_store(path: str, classes=None):
    """Read the HDF5 object store back into the ``object_aware_splits``
    input shape: class -> list of {'spectral_data': array} (one entry per
    object, images flattened; vae_bce_nut.py:65-76)."""
    import h5py

    out = {}
    with h5py.File(path, "r") as h5f:
        names = list(classes) if classes is not None else list(h5f.keys())
        for cls in names:
            objs = []
            grp = h5f[cls]
            for img_key in sorted(grp.keys()):
                img = grp[img_key]
                for obj_key in sorted(img.keys()):
                    objs.append({
                        "spectral_data": np.asarray(img[obj_key]["spectra"]),
                        **dict(img[obj_key].attrs),
                    })
            out[cls] = objs
    return out


# ---------------------------------------------------------------------------
# Run artifacts (params/losses/metrics JSON)
# ---------------------------------------------------------------------------

def _to_jsonable(obj):
    if isinstance(obj, Mapping):
        return {str(k): _to_jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_to_jsonable(v) for v in obj]
    if isinstance(obj, torch.Tensor):
        # .item() raises on a tensor of several elements
        return obj.detach().cpu().tolist()
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, (np.floating, np.integer)):
        return obj.item()
    if hasattr(obj, "item") and not isinstance(obj, (str, bytes)):
        try:
            return obj.item()
        except Exception:
            pass
    return obj


def save_json(payload, run_dir: str, name: str) -> str:
    """Write one artifact JSON into a run directory
    (utils/final_vaesimca.py:316-322 pattern)."""
    os.makedirs(run_dir, exist_ok=True)
    path = os.path.join(run_dir, name)
    with open(path, "w") as f:
        json.dump(_to_jsonable(payload), f, indent=2)
    return path


def load_json(run_dir: str, name: str):
    with open(os.path.join(run_dir, name)) as f:
        return json.load(f)
