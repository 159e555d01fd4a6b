"""ctypes loader for the port's host C++ core (``csrc/ccl.cpp``).

Port of ``ocm_tpu/utils/native.py``.  The shared library is compiled at
first use with ``g++ -O3 -std=c++17 -fPIC -shared -pthread`` into the
package's git-ignored ``_build/`` directory, named by a hash of its source
and flags (as ``ops/_build.py`` names the CUDA objects), and loaded with
ctypes.  It is a library of its own, separate from the CUDA one, so the
CPU and the data layer never wait for ``nvcc``.  A failed build raises
with the compiler's output: no entry point falls back quietly.

- ``mean_image(cube)``          — wavelength mean, threaded
- ``label(mask)``               — 8-connected components, two-pass
                                  union-find; output identical to
                                  ``scipy.ndimage.label(mask, ones((3, 3)))``
- ``object_sizes(labels, n)``   — pixels a label
- ``gather_object(cube, labels, k)`` — dense (n_pixels, L) spectra block
                                  and (y, x) coordinates of one object
- ``extract_objects_native(cube, thr)`` — the twin of
  ``utils.io.extract_objects`` built on the four above
- ``quantize_rows_int8(x, center=None)`` — fused center + per-row int8
  quantization + exact row norms, bit-identical to the numpy arithmetic
  (``quantize_rows_int8_plain``): ``SIMCAScorer``'s int8 chunk prep.

Each entry point has a named plain twin in numpy or scipy
(``*_plain``), which the tests hold it against; no path uses them.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "ccl.cpp"
BUILD_DIR = _PKG / "_build"
FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread")

_I64, _I32 = ctypes.c_int64, ctypes.c_int32
_I32P, _F32P = ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_float)
_U8P, _I8P = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int8)
# entry point -> (argument types, result type)
ENTRY_POINTS = {
    "ocm_threads_for": ([_I64], _I32),
    "ocm_mean_image": ([_F32P, _I64, _I64, _I64, _F32P], None),
    "ocm_label": ([_U8P, _I64, _I64, _I32P], _I32),
    "ocm_object_sizes": ([_I32P, _I64, _I32, _I32P], None),
    "ocm_gather_object": ([_F32P, _I32P, _I64, _I64, _I64, _I32, _F32P,
                           _I32P], None),
    "ocm_quantize_rows_int8": ([_F32P, _F32P, _I64, _I64, _I8P, _F32P,
                                _F32P], None),
}


def library_path(source: Path = SOURCE, build_dir: Path = BUILD_DIR) -> Path:
    """Where the library of ``source`` with ``FLAGS`` lives."""
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(Path(source).read_bytes())
    return Path(build_dir) / f"libocm_ccl_{h.hexdigest()[:16]}.so"


def build(source: Path = SOURCE, build_dir: Path = BUILD_DIR) -> Path:
    """Compile ``source`` with g++ unless its library is already built;
    returns the library's path.  Raises with the compiler's output if the
    build fails."""
    out = library_path(source, build_dir)
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found on PATH; the port's host C++ core "
                           "(csrc/ccl.cpp) needs it to build")
    Path(build_dir).mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [cxx, *FLAGS, str(source), "-o", str(tmp)]
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed ({r.returncode}): {' '.join(cmd)}\n"
                           f"{r.stdout}{r.stderr}")
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded library, built at first use, with typed entry points."""
    lib = ctypes.CDLL(str(build()))
    for name, (argtypes, restype) in ENTRY_POINTS.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, restype
    return lib


def available() -> bool:
    """Whether the library builds and loads here (a report: the entry
    points themselves raise the build's error)."""
    try:
        library()
    except (RuntimeError, OSError):
        return False
    return True


def threads_for(work: int) -> int:
    """The threads the library's passes use for ``work`` elements (the
    host's ``hardware_concurrency()``, at most one a 65,536 elements)."""
    return int(library().ocm_threads_for(int(work)))


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _cube(cube) -> np.ndarray:
    cube = np.ascontiguousarray(cube, dtype=np.float32)
    if cube.ndim != 3:
        raise ValueError(f"expected an (H, W, L) cube, got shape {cube.shape}")
    return cube


def mean_image(cube) -> np.ndarray:
    """Mean over the wavelength axis of a (H, W, L) cube, f32 (accumulated
    in double)."""
    cube = _cube(cube)
    h, w, l = cube.shape
    out = np.empty((h, w), dtype=np.float32)
    library().ocm_mean_image(_ptr(cube, ctypes.c_float), h, w, l,
                             _ptr(out, ctypes.c_float))
    return out


def mean_image_plain(cube) -> np.ndarray:
    """numpy twin of ``mean_image`` (f32 sums: equal to rounding)."""
    return np.ascontiguousarray(cube, dtype=np.float32).mean(axis=2)


def label(mask):
    """8-connected component labeling of a 2-D mask; returns (labels
    int32, n_objects), identical to
    ``scipy.ndimage.label(mask, np.ones((3, 3)))``."""
    m8 = np.ascontiguousarray(np.asarray(mask).astype(bool, copy=False),
                              dtype=np.uint8)
    if m8.ndim != 2:
        raise ValueError(f"expected a 2-D mask, got shape {m8.shape}")
    h, w = m8.shape
    labels = np.empty((h, w), dtype=np.int32)
    n = library().ocm_label(_ptr(m8, ctypes.c_uint8), h, w,
                            _ptr(labels, ctypes.c_int32))
    return labels, int(n)


def label_plain(mask):
    """scipy twin of ``label``."""
    from scipy import ndimage

    labels, n = ndimage.label(mask, structure=np.ones((3, 3), int))
    return labels.astype(np.int32), int(n)


def object_sizes(labels, n_objects: int) -> np.ndarray:
    """(n_objects,) int32 pixel counts of labels 1..n_objects."""
    labels = np.ascontiguousarray(labels, dtype=np.int32)
    sizes = np.empty(n_objects, dtype=np.int32)
    library().ocm_object_sizes(_ptr(labels, ctypes.c_int32), labels.size,
                               n_objects, _ptr(sizes, ctypes.c_int32))
    return sizes


def object_sizes_plain(labels, n_objects: int) -> np.ndarray:
    """numpy twin of ``object_sizes``."""
    counts = np.bincount(np.ravel(labels), minlength=n_objects + 1)
    return counts[1:n_objects + 1].astype(np.int32)


def gather_object(cube, labels, obj: int, n_pixels: Optional[int] = None):
    """(spectra (n, L) f32, coords (n, 2) int32 (y, x)) of the pixels of
    label ``obj``, in row-major scan order."""
    cube = _cube(cube)
    labels = np.ascontiguousarray(labels, dtype=np.int32)
    h, w, l = cube.shape
    if labels.shape != (h, w):
        raise ValueError(f"labels shape {labels.shape} does not match the "
                         f"cube's (H, W) = {(h, w)}")
    count = int(np.count_nonzero(labels == obj))
    if n_pixels is not None and int(n_pixels) != count:
        raise ValueError(f"object {obj} has {count} pixels, not {n_pixels}")
    out = np.empty((count, l), dtype=np.float32)
    coords = np.empty((count, 2), dtype=np.int32)
    library().ocm_gather_object(_ptr(cube, ctypes.c_float),
                                _ptr(labels, ctypes.c_int32), h, w, l, obj,
                                _ptr(out, ctypes.c_float),
                                _ptr(coords, ctypes.c_int32))
    return out, coords


def gather_object_plain(cube, labels, obj: int):
    """numpy twin of ``gather_object``."""
    mask = np.asarray(labels) == obj
    return (np.ascontiguousarray(np.asarray(cube)[mask], dtype=np.float32),
            np.argwhere(mask).astype(np.int32))


def extract_objects_native(cube, background_threshold: float,
                           min_pixels: int = 1):
    """Twin of ``utils.io.extract_objects`` (nut_data.py:65-160) on the
    native core: the same list of object dicts ('spectral_data',
    'mean_spectrum', 'centroid', 'n_pixels', 'obj_idx').  The cube is
    copied to f32 once (as the reference does)."""
    cube = _cube(cube)
    foreground = mean_image(cube) >= background_threshold
    labels, n_objects = label(foreground)
    sizes = object_sizes(labels, n_objects)
    objects = []
    for obj_idx in range(1, n_objects + 1):
        n_px = int(sizes[obj_idx - 1])
        if n_px < min_pixels:
            continue
        spectra, coords = gather_object(cube, labels, obj_idx, n_px)
        objects.append({
            "spectral_data": spectra,
            "mean_spectrum": spectra.mean(axis=0),
            "centroid": tuple(coords.mean(axis=0).tolist()),
            "n_pixels": n_px,
            "obj_idx": obj_idx,
        })
    return objects


def _center(center, length: int) -> Optional[np.ndarray]:
    if center is None:
        return None
    center = np.ascontiguousarray(center, dtype=np.float32)
    if center.shape != (length,):
        raise ValueError(f"center must be shape ({length},), got "
                         f"{center.shape}")
    return center


def quantize_rows_int8(a, center=None):
    """Per-row symmetric int8 quantization of ``a - center`` (``center``
    (L,) or None) over the last axis, in one threaded pass a row: returns
    ``(q int8, scale f32, sumsq f32)``, bit-identical to
    ``quantize_rows_int8_plain`` (f32 ``amax / 127`` floored at 1e-30,
    round half to even, clip to +-127, the int32 sum of squares cast to
    f32 then scaled left to right)."""
    a = np.ascontiguousarray(a, dtype=np.float32)
    shape = a.shape
    l = shape[-1]
    n = a.size // l if l else 0
    center = _center(center, l)
    q = np.empty(shape, dtype=np.int8)
    scale = np.empty(shape[:-1], dtype=np.float32)
    sumsq = np.empty(shape[:-1], dtype=np.float32)
    library().ocm_quantize_rows_int8(
        _ptr(a, ctypes.c_float),
        None if center is None else _ptr(center, ctypes.c_float),
        n, l, _ptr(q, ctypes.c_int8), _ptr(scale, ctypes.c_float),
        _ptr(sumsq, ctypes.c_float))
    return q, scale, sumsq


def quantize_rows_int8_plain(a, center=None):
    """numpy twin of ``quantize_rows_int8``: center in f32, then the f32
    arithmetic of ``ops.linalg.quantize_rows_int8``."""
    a = np.asarray(a).astype(np.float32, copy=False)
    center = _center(center, a.shape[-1])
    if center is not None:
        a = a - center
    scale = np.maximum(np.abs(a).max(-1) / np.float32(127.0),
                       np.float32(1e-30)).astype(np.float32)
    q = np.clip(np.round(a / scale[..., None]), -127, 127).astype(np.int8)
    sumsq = (np.sum(q.astype(np.int32) ** 2, axis=-1).astype(np.float32)
             * scale * scale)
    return q, scale, sumsq
