"""Build and load the port's CUDA kernels.

The sources in ``ocm_tpu_torch/csrc`` expose a plain C interface.  Each
``.cu`` is compiled with ``nvcc`` for Hopper (``sm_90a``) into its own
object, all of them at once in parallel processes, and the objects are
linked into one shared library that is loaded with ``ctypes``.  Objects
and library land in ``ocm_tpu_torch/_build/`` (git-ignored), each named by
a hash of what it is built from (source, shared headers, flags), so an
edited source rebuilds only its own object and an unchanged tree loads at
once.  Each object's compiler resource report (``-Xptxas -v``: registers,
shared memory and spills of every kernel) is kept beside it as
``<object>.log``; ``build_logs`` returns them.

Every C entry point returns the ``cudaGetLastError()`` of its launch (or
of its query); ``check`` turns a non-zero code into an exception through
the library's one error-string function, ``ocm_error_string``.
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
SOURCES = ("common.cu", "t2q_scores.cu", "bn_act.cu", "reparam_kl.cu",
           "reparam_sample.cu", "int8.cu")
HEADERS = ("common.cuh",)
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                 "-Xptxas", "-v")
LINK_FLAGS = (*ARCH, "-shared", "-Xcompiler", "-fPIC")

_P, _I, _F, _U64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
    ctypes.c_uint64
# entry point -> argument types (pointers and the stream as c_void_p)
ENTRY_POINTS = {
    "t2q_scores_multiclass_f32": [_P] * 6 + [_I] * 11 + [_P],
    "t2q_scores_multiclass_bf16": [_P] * 6 + [_I] * 11 + [_P],
    "ocm_device_limits": [_I, ctypes.POINTER(_I), ctypes.POINTER(_I)],
    "int8_tile_sum": [_P] * 2 + [_I] * 3 + [_P],
    "int8_gemm_s32": [_P] * 3 + [_I] * 4 + [_P],
    "bn_act_fwd_f32": [_P] * 6 + [_I] * 3 + [_F, _I, _I, _P],
    "bn_act_bwd_f32": [_P] * 9 + [_I] * 3 + [_F, _I, _I, _P],
    "bn_act_eval_f32": [_P] * 6 + [_I] * 4 + [_P],
    # reparam: pointers, n, k, (dz and dkl strides,) (seed, offset,) then
    # reparam_plan's lanes, rows, blocks and vector bytes
    "reparam_kl_f32": [_P] * 5 + [_I] * 6 + [_P],
    "reparam_kl_bwd_f32": [_P] * 7 + [_I] * 9 + [_P],
    "reparam_kl_sample_f32": [_P] * 5 + [_I] * 2 + [_U64] * 2 + [_I] * 4
    + [_P],
    "ocm_noop": [_P],
}


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


def _digest(*parts: bytes) -> str:
    h = hashlib.sha256()
    for part in parts:
        h.update(part)
    return h.hexdigest()[:16]


def object_path(name: str) -> Path:
    """Where the object of source ``name`` for the current tree lives."""
    digest = _digest(" ".join(COMPILE_FLAGS).encode(),
                     *((CSRC / h).read_bytes() for h in HEADERS),
                     (CSRC / name).read_bytes())
    return BUILD_DIR / f"{Path(name).stem}_{digest}.o"


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    digest = _digest(" ".join(LINK_FLAGS).encode(),
                     *(object_path(name).name.encode() for name in SOURCES))
    return BUILD_DIR / f"libocm_tpu_torch_{digest}.so"


def _run(cmd: list[str]) -> None:
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed ({r.returncode}): {' '.join(cmd)}\n"
                           f"{r.stdout}{r.stderr}")


def build() -> Path:
    """Compile what is missing (one nvcc per source, all started together)
    and link the library unless it is already built; returns its path."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(exist_ok=True)
    nvcc, pid = _nvcc(), os.getpid()
    jobs = []
    for name in SOURCES:
        obj = object_path(name)
        if obj.exists():
            continue
        tmp = obj.with_name(f"{obj.stem}.{pid}.tmp.o")
        log = obj.with_name(f"{obj.stem}.{pid}.tmp.log")
        cmd = [nvcc, *COMPILE_FLAGS, "-c", str(CSRC / name), "-o", str(tmp)]
        with open(log, "w") as f:
            proc = subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT)
        jobs.append((cmd, obj, tmp, log, proc))
    failed = []
    for cmd, obj, tmp, log, proc in jobs:
        if proc.wait() != 0:
            failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}"
                          f"\n{log.read_text()}")
            continue
        os.replace(log, obj.with_suffix(".log"))
        os.replace(tmp, obj)
    if failed:
        raise RuntimeError("\n".join(failed))
    tmp = out.with_name(f"{out.stem}.{pid}.tmp")
    _run([nvcc, *LINK_FLAGS, "-o", str(tmp),
          *(str(object_path(name)) for name in SOURCES)])
    os.replace(tmp, out)
    return out


def build_logs() -> dict[str, str]:
    """Each source's compiler report (``-Xptxas -v``) from its build."""
    logs = {}
    for name in SOURCES:
        log = object_path(name).with_suffix(".log")
        logs[name] = log.read_text() if log.exists() else "(no log)"
    return logs


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built at first use, with typed entry points."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in ENTRY_POINTS.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.ocm_error_string.argtypes = [ctypes.c_int]
    lib.ocm_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def device_limits(index: int) -> tuple[int, int]:
    """(SMs, the most shared memory a block may opt in to, bytes) of CUDA
    device ``index``, which the launch plans size their grids by."""
    sms, smem = ctypes.c_int(0), ctypes.c_int(0)
    check(library().ocm_device_limits(index, ctypes.byref(sms),
                                      ctypes.byref(smem)), "device limits")
    return sms.value, smem.value


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        msg = library().ocm_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
