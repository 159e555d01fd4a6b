"""Build and load the port's CUDA kernels.

The sources in ``ocm_tpu_torch/csrc`` expose a plain C interface; they are
compiled with ``nvcc`` for Hopper (``sm_90a``) into one shared library at
first use and loaded with ``ctypes``.  The library lands in
``ocm_tpu_torch/_build/`` (git-ignored), named by a hash of the sources
and flags, so an edited source rebuilds and an unchanged one loads at
once.  The compiler's resource report (``-Xptxas -v``) is kept beside the
library as ``<name>.log``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("t2q_scores.cu",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the "
                           "CUDA kernels need the CUDA toolkit to build")
    return path


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"libocm_tpu_torch_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless it is already built; returns its path."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *(str(CSRC / name) for name in SOURCES)]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed ({r.returncode}): {' '.join(cmd)}\n"
                           f"{r.stdout}{r.stderr}")
    out.with_suffix(".log").write_text(r.stdout + r.stderr)
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built at first use, with typed entry points."""
    lib = ctypes.CDLL(str(build()))
    fn = lib.t2q_scores_multiclass_f32
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.t2q_error_string.argtypes = [ctypes.c_int]
    lib.t2q_error_string.restype = ctypes.c_char_p
    return lib
