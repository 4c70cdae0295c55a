"""Build and load the CUDA kernels of ``gpuradixsort_tpu_torch/csrc``.

The sources have a plain C interface, so ``nvcc`` compiles them in seconds,
one process per source, all at once, and links them into one shared library
under ``build/kernels/`` at the repository root, which is loaded with
``ctypes``.  The library's name carries a hash of the
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
import tempfile

import torch

_CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "kernels"

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64

# Entry point -> argument types.  Every pointer and the stream is c_void_p.
_SIGNATURES = {
    "grs_radix_hist": [_P, _P, _I64, _I, _I, _I, _I, _P, _I, _P, _P, _P],
    "grs_bucketize": [_P, _P, _P, _P, _I64, _I, _I, _I, _I, _P],
    "grs_scatter_runs": [_P, _P, _P, _P, _P, _P, _I64, _I, _I, _P],
    "grs_bucketize_scatter": [_P, _P, _P, _P, _P, _P, _P, _I64, _I, _I, _I, _I, _P, _I, _P],
    "grs_radix_dest": [_P, _P, _P, _I64, _I, _I, _I, _I, _P],
    "grs_radix_dest_scatter": [_P, _P, _P, _P, _I, _I64, _I, _I, _I, _I, _P],
    "grs_exclusive_scan": [_P, _P, _I64, _I, _P, _P],
    "grs_lookback_scatter": [_P, _P, _P, _I64, _I, _I, _P, _I, _P, _P, _I64, _P],
    "grs_key_bits": [_P, _I64, _P, _P, _I, _I, _P, _P],
    "grs_sort_plan": [_P, _I64, _P, _P, _I, _I, _P, _P, _I64, _P],
    "grs_sort_args": [_P, _P, _P, _P, _P, _I64, _I64, _P],
}


def sources(csrc: pathlib.Path = _CSRC) -> list[pathlib.Path]:
    """The translation units; each includes its headers from csrc/."""
    return sorted(csrc.glob("*.cu"))


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    found = shutil.which("nvcc") or shutil.which(os.path.join(cuda_home, "bin", "nvcc"))
    if found is None:
        raise RuntimeError(
            f"nvcc not found on PATH or under {cuda_home}; the CUDA kernels "
            "need the CUDA toolkit"
        )
    return found


def library_path(csrc: pathlib.Path = _CSRC, build_dir: pathlib.Path = BUILD_DIR) -> pathlib.Path:
    digest = hashlib.sha256()
    for src in sorted(csrc.glob("*.cu*")):  # sources and their headers
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return build_dir / f"libgrs_kernels_{digest.hexdigest()[:16]}.so"


def _run_all(cmds: list[list[str]]) -> None:
    """Run the commands at once; wait for all, then raise if any failed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for c in cmds]
    failures = []
    for cmd, proc in zip(cmds, procs):
        _, err = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{err}")
    if failures:
        raise RuntimeError("\n".join(failures))


def build(csrc: pathlib.Path = _CSRC, build_dir: pathlib.Path = BUILD_DIR) -> pathlib.Path:
    """Compile the sources of ``csrc`` for sm_90a unless this exact build exists.

    The defaults build the port's own sources; another directory (an older
    copy of them, to time against) builds the same way into ``build_dir``.
    """
    out = library_path(csrc, build_dir)
    if out.exists():
        return out
    build_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=build_dir) as tmpdir:
        objs = [pathlib.Path(tmpdir) / f"{src.stem}.o" for src in sources(csrc)]
        _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                  for src, obj in zip(sources(csrc), objs)])
        tmp = pathlib.Path(tmpdir) / out.name
        _run_all([[nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]])
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
