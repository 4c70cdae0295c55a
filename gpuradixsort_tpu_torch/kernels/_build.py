"""Build and load the CUDA kernels of ``gpuradixsort_tpu_torch/csrc``.

The sources have a plain C interface, so ``nvcc`` compiles them in seconds
into one shared library under ``build/kernels/`` at the repository root,
which is loaded with ``ctypes``.  The library's name carries a hash of the
sources, so an edited source is never served by a stale build.  The build
runs at first use, never at import.  When it or the load fails, this module
raises: there is no fall-back to the plain versions.

Every C entry point returns ``cudaGetLastError()`` after its launch, because
a refused launch never runs and ``torch.cuda.synchronize()`` does not report
it; ``launch`` turns a non-zero code into an exception.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess

import torch

_CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "kernels"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64

# Entry point -> argument types.  Every pointer and the stream is c_void_p.
_SIGNATURES = {
    "grs_radix_hist": [_P, _P, _I64, _I, _I, _I, _P],
    "grs_bucketize": [_P, _P, _P, _P, _I64, _I, _I, _I, _I, _P],
    "grs_scatter_runs": [_P, _P, _P, _P, _P, _P, _I64, _I, _I, _P],
}


def sources() -> list[pathlib.Path]:
    """The translation units; each includes its headers from csrc/."""
    return sorted(_CSRC.glob("*.cu"))


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    found = shutil.which("nvcc") or shutil.which(os.path.join(cuda_home, "bin", "nvcc"))
    if found is None:
        raise RuntimeError(
            f"nvcc not found on PATH or under {cuda_home}; the CUDA kernels "
            "need the CUDA toolkit"
        )
    return found


def library_path() -> pathlib.Path:
    digest = hashlib.sha256()
    for src in sorted(_CSRC.glob("*.cu*")):  # sources and their headers
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libgrs_kernels_{digest.hexdigest()[:16]}.so"


def build() -> pathlib.Path:
    """Compile the sources for sm_90a unless this exact build exists."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}"
        )
    os.replace(tmp, out)
    return out


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.grs_error_string.argtypes = [ctypes.c_int]
    lib.grs_error_string.restype = ctypes.c_char_p
    return lib


def launch(name: str, like: torch.Tensor, *args) -> None:
    """Call entry point ``name`` on ``like``'s device and current stream.

    Raises when the entry point reports a CUDA error for its launch.
    """
    lib = library()
    with torch.cuda.device(like.device):
        err = getattr(lib, name)(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        msg = lib.grs_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} at launch: {msg}")
