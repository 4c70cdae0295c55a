"""ctypes bridge to the native host runtime (``native/qehost.cpp``).

The port's own loader: it compiles ``native/qehost.cpp`` with ``g++`` into
``build/native/`` at the repository root on first use (the library's name
carries a hash of the source, so an edited source is never served by a stale
build), and never writes under ``native/``.  Where no toolchain is found or
the build fails, every function falls back to numpy and gives the same
result, only slower.  These are host helpers (data generation, the oracle
sort, the is-sorted scan), not kernels of the port.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

import numpy as np

_ROOT = pathlib.Path(__file__).resolve().parents[2]
_SOURCE = _ROOT / "native" / "qehost.cpp"
BUILD_DIR = _ROOT / "build" / "native"

_U32P = ctypes.POINTER(ctypes.c_uint32)


def library_path() -> pathlib.Path:
    digest = hashlib.sha256(_SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libqehost_{digest}.so"


def _build() -> pathlib.Path:
    """Compile the source unless this exact build exists; raises on failure."""
    out = library_path()
    if out.exists():
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) found")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        tmp_so = pathlib.Path(tmp) / out.name
        subprocess.run([cxx, "-O3", "-std=c++17", "-fPIC", "-shared", "-o", str(tmp_so),
                        str(_SOURCE)], check=True, capture_output=True, timeout=120)
        os.replace(tmp_so, out)  # atomic: concurrent builders each publish a whole file
    return out


@functools.cache
def _load():
    """The loaded library, or None where it cannot be built or loaded."""
    try:
        lib = ctypes.CDLL(str(_build()))
    except (OSError, RuntimeError, subprocess.SubprocessError):
        return None
    lib.qe_first_unsorted_u32.restype = ctypes.c_int64
    lib.qe_first_unsorted_u32.argtypes = [_U32P, ctypes.c_int64]
    for name in ("qe_random_u32", "qe_shuffled_permutation"):
        fn = getattr(lib, name)
        fn.restype = None
        fn.argtypes = [_U32P, ctypes.c_int64, ctypes.c_uint64]
    lib.qe_radix_sort_pairs_u32.restype = None
    lib.qe_radix_sort_pairs_u32.argtypes = [_U32P, _U32P, ctypes.c_int64]
    return lib


def _u32ptr(arr: np.ndarray):
    return arr.ctypes.data_as(_U32P)


def available() -> bool:
    return _load() is not None


def first_unsorted(keys: np.ndarray) -> int:
    """Index of the first order violation, or -1 if sorted."""
    keys = np.ascontiguousarray(keys, dtype=np.uint32)
    lib = _load()
    if lib is not None:
        return int(lib.qe_first_unsorted_u32(_u32ptr(keys), keys.shape[0]))
    bad = np.nonzero(keys[1:] < keys[:-1])[0]
    return int(bad[0] + 1) if bad.size else -1


def random_keys(n: int, seed: int = 0) -> np.ndarray:
    """n uniform uint32 keys from ``seed`` (splitmix64 natively, numpy's PCG64 otherwise)."""
    out = np.empty(n, dtype=np.uint32)
    lib = _load()
    if lib is not None:
        lib.qe_random_u32(_u32ptr(out), n, seed)
        return out
    return np.random.default_rng(seed).integers(0, 2**32, size=n, dtype=np.uint32)


def shuffled_permutation(n: int, seed: int = 0) -> np.ndarray:
    """The reference's demo dataset: shuffled 0..N-1."""
    out = np.empty(n, dtype=np.uint32)
    lib = _load()
    if lib is not None:
        lib.qe_shuffled_permutation(_u32ptr(out), n, seed)
        return out
    return np.random.default_rng(seed).permutation(n).astype(np.uint32)


def radix_sort_pairs(keys: np.ndarray, idx: np.ndarray | None = None):
    """Stable CPU oracle sort of (key, index) pairs; returns sorted copies."""
    keys = np.ascontiguousarray(keys, dtype=np.uint32).copy()
    if idx is None:
        idx = np.arange(keys.shape[0], dtype=np.uint32)
    else:
        idx = np.ascontiguousarray(idx, dtype=np.uint32).copy()
    lib = _load()
    if lib is not None:
        lib.qe_radix_sort_pairs_u32(_u32ptr(keys), _u32ptr(idx), keys.shape[0])
        return keys, idx
    order = np.argsort(keys, kind="stable")
    return keys[order], idx[order]
