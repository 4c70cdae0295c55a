"""The PyTorch port's config and columnar tables against the JAX package.

Padded buffers must be equal bit for bit, in length, dtype and pad values,
so that every later parity test compares buffers of one length.  Also holds
the port to its import and device rules: it imports neither JAX nor Triton,
and a CUDA request on a machine with no card raises instead of falling back
to the CPU.
"""

import ctypes
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from gpuradixsort_tpu import config as jconfig
from gpuradixsort_tpu.core import table as jtable
from gpuradixsort_tpu_torch import config as tconfig
from gpuradixsort_tpu_torch.core import table as ttable
from gpuradixsort_tpu_torch.kernels import _build
from gpuradixsort_tpu_torch.kernels.radix import tile_histograms
from gpuradixsort_tpu_torch.ops import sort as tsort

torch.set_num_threads(1)

CFG = tconfig.EngineConfig()
JCFG = jconfig.EngineConfig()
BLOCK = CFG.block
SIZES = [1, 1000, BLOCK - 1, BLOCK + 1, 3 * BLOCK + 17]


def _same_buffer(tcol, jcol):
    want = np.asarray(jcol.data)
    got = tcol.data.numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert tcol.length == jcol.length
    assert tcol.padded_length == jcol.padded_length
    assert tcol.to_numpy().dtype == jcol.to_numpy().dtype
    np.testing.assert_array_equal(tcol.to_numpy(), jcol.to_numpy())


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
def test_config_matches_jax(bits):
    t = tconfig.EngineConfig(radix_bits=bits)
    j = jconfig.EngineConfig(radix_bits=bits)
    assert (t.radix, t.tile, t.block, t.num_passes) == (j.radix, j.tile, j.block, j.num_passes)
    assert tconfig.config_from_jax(j) == t
    assert tconfig.LANES == jconfig.LANES
    assert tconfig.TILES_PER_STEP == jconfig.TILES_PER_STEP
    assert tconfig.PAD_KEY == int(jconfig.PAD_KEY) == 0xFFFFFFFF
    assert tconfig.PAD_INDEX == int(jconfig.PAD_INDEX) == 0xFFFFFFFF


def test_config_rejects_bad_values():
    with pytest.raises(ValueError):
        tconfig.EngineConfig(radix_bits=3)
    with pytest.raises(ValueError):
        tconfig.EngineConfig(radix_bits=16)
    with pytest.raises(ValueError):
        tconfig.EngineConfig(tile_rows=0)
    assert tconfig.REFERENCE_PARITY_CONFIG.num_passes == 32
    assert tconfig.DEFAULT_CONFIG == CFG


@pytest.mark.parametrize("n", SIZES)
def test_round_up_matches_jax(n):
    assert ttable.round_up(n, BLOCK) == jtable.round_up(n, BLOCK)


@pytest.mark.parametrize("n", SIZES)
def test_make_key_column_matches_jax(n, rng):
    keys = rng.integers(0, 2**32, size=n, dtype=np.uint32)
    _same_buffer(ttable.make_key_column(keys, CFG, device="cpu"), jtable.make_key_column(keys, JCFG))
    # A uint32 tensor takes the tensor path, with the same result.
    _same_buffer(
        ttable.make_key_column(torch.from_numpy(keys), CFG),
        jtable.make_key_column(keys, JCFG),
    )


@pytest.mark.parametrize("n", SIZES)
def test_make_column_matches_jax(n, rng):
    ints = rng.integers(-(2**31), 2**31, size=n, dtype=np.int64)  # narrows to int32
    floats = rng.standard_normal(n)  # float64 narrows to float32
    rows = rng.integers(0, 2**31, size=(n, 16)).astype(np.int32)  # 64-byte rows
    for values, fill in ((ints, 0), (floats, 0), (rows, 0), (ints, 7)):
        _same_buffer(
            ttable.make_column(values, CFG, fill=fill, device="cpu"),
            jtable.make_column(values, JCFG, fill=fill),
        )


@pytest.mark.parametrize("n", SIZES)
def test_table_from_arrays_and_from_jax(n, rng):
    arrays = {
        "a": rng.integers(0, 1000, size=n).astype(np.int32),
        "b": rng.standard_normal(n).astype(np.float32),
        "k": rng.integers(0, 2**32, size=n, dtype=np.uint32),
    }
    jt = jtable.table_from_arrays(JCFG, **arrays)
    tt = ttable.table_from_arrays(CFG, device="cpu", **arrays)
    carried = ttable.table_from_jax(jt, device="cpu")
    assert tt.names() == jt.names() == carried.names()
    assert tt.length == jt.length == carried.length == n
    for name in jt.names():
        _same_buffer(tt[name], jt[name])
        _same_buffer(carried[name], jt[name])
    key = jtable.make_key_column(arrays["k"], JCFG)
    _same_buffer(ttable.column_from_jax(key, device="cpu"), key)
    _same_buffer(carried.with_column("k", ttable.column_from_jax(key, device="cpu"))["k"], key)


def test_pad_to_tile_tensor_path():
    arr = torch.arange(5, dtype=torch.int32).view(torch.uint32)
    out = ttable.pad_to_tile(arr, CFG, 0xFFFFFFFF)
    assert out.dtype == torch.uint32 and out.shape == (BLOCK,)
    np.testing.assert_array_equal(out.numpy()[:5], np.arange(5, dtype=np.uint32))
    assert (out.numpy()[5:] == np.uint32(0xFFFFFFFF)).all()
    full = torch.zeros(BLOCK, dtype=torch.float32)
    assert ttable.pad_to_tile(full, CFG, 1.0) is full
    assert ttable.uint32_as_int32(0xFFFFFFFF) == -1
    assert ttable.uint32_as_int32(5) == 5


def test_column_and_table_checks():
    with pytest.raises(ValueError):
        ttable.Column(torch.zeros(4, dtype=torch.int32), 5)
    a = ttable.make_column(np.arange(3, dtype=np.int32), CFG, device="cpu")
    b = ttable.make_column(np.arange(4, dtype=np.int32), CFG, device="cpu")
    with pytest.raises(ValueError):
        ttable.Table({"a": a, "b": b})
    with pytest.raises(TypeError):
        ttable.make_key_column(torch.arange(3, dtype=torch.int64), CFG)
    assert ttable.Table({}).length == 0


def test_port_imports_neither_jax_nor_triton():
    code = (
        "import sys\n"
        "import gpuradixsort_tpu_torch.ops.sort\n"
        "import gpuradixsort_tpu_torch.utils.verify\n"
        "import gpuradixsort_tpu_torch.utils.timing\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'triton', 'gpuradixsort_tpu'))\n"
        "print(','.join(bad))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, check=True,
        timeout=120,
    )
    assert out.stdout.strip() == ""


def test_cuda_request_without_a_card_raises(rng):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    keys = rng.integers(0, 2**32, size=100, dtype=np.uint32)
    with pytest.raises((RuntimeError, AssertionError)):
        ttable.make_key_column(keys, CFG, device="cuda")
    cpu_keys = ttable.make_key_column(keys, CFG, device="cpu").data
    # Asking for the kernel on a CPU tensor raises; it never runs the plain
    # version in its place.
    with pytest.raises(ValueError, match="CUDA tensor"):
        tile_histograms(cpu_keys, 0, CFG, impl="cuda")
    assert tconfig.resolve_impl(cpu_keys, None) == "reference"
    with pytest.raises(ValueError):
        tconfig.resolve_impl(cpu_keys, "mosaic")


def test_host_values_need_a_card_unless_cpu(monkeypatch, rng):
    # As on a machine without a card: host values go nowhere quietly.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    keys = rng.integers(0, 2**32, size=100, dtype=np.uint32)
    jt = jtable.table_from_arrays(JCFG, k=keys)
    builders = {
        "make_column": lambda **kw: ttable.make_column(keys, CFG, **kw),
        "make_key_column": lambda **kw: ttable.make_key_column(keys, CFG, **kw),
        "table_from_arrays": lambda **kw: ttable.table_from_arrays(CFG, k=keys, **kw)["k"],
        "column_from_jax": lambda **kw: ttable.column_from_jax(jt["k"], **kw),
        "table_from_jax": lambda **kw: ttable.table_from_jax(jt, **kw)["k"],
        "sort_keys": lambda **kw: tsort.sort_keys(keys, CFG, **kw),
        "sort_pairs": lambda **kw: tsort.sort_pairs(keys, CFG, **kw)[0],
    }
    for name, build in builders.items():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()
        assert build(device="cpu").device == torch.device("cpu"), name
    # A tensor keeps its own device: no card is needed for a CPU tensor.
    col = ttable.make_key_column(torch.from_numpy(keys), CFG)
    assert col.device == torch.device("cpu")
    assert tsort.sort_keys(col, CFG).device == torch.device("cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tconfig.default_device()
    assert tconfig.default_device("cpu") == torch.device("cpu")


def test_kernel_build_without_nvcc_raises(monkeypatch):
    if shutil.which("nvcc"):
        pytest.skip("this machine has nvcc")
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.library()
    assert all(src.suffix == ".cu" for src in _build.sources())
    assert {src.name for src in _build.sources()} == {
        "radix_hist.cu", "bucketize.cu", "scatter_runs.cu", "bucketize_scatter.cu",
        "radix_dest.cu", "scan.cu", "sort_plan.cu", "segment_agg.cu", "gather_rows.cu",
        "join_probe.cu",
    }


# The C declarations of the entry points, and how each argument's kind reads
# as the ctypes type that ``_build.library()`` gives it.
_DECLARATION = re.compile(r'extern "C" [^(]*?\b(grs_\w+)\(([^)]*)\)')
_KINDS = {"int64_t": ctypes.c_int64, "int": ctypes.c_int}
# Entry points that the library does not type: the error string (typed by
# hand) and the group-by's trace, which agg_ab.py loads itself.
_UNTYPED = {"grs_error_string", "grs_segment_aggregate_trace"}


def _declarations() -> dict:
    """Every ``extern "C"`` grs_* entry point of csrc/: its arguments' ctypes types."""
    found = {}
    for src in _build.sources():
        for name, params in _DECLARATION.findall(src.read_text()):
            found[name] = [ctypes.c_void_p if "*" in p else _KINDS[p.split()[0]]
                           for p in " ".join(params.split()).split(", ")]
    return found


@pytest.mark.parametrize("name", sorted(_build._SIGNATURES))
def test_kernel_signatures_match_the_sources(name):
    # What only library() on the card would find: each typed entry point is
    # declared in a source, with an argument of the same kind (pointer,
    # int64_t, int) at every place.
    assert _declarations().get(name) == _build._SIGNATURES[name]


def test_kernel_signatures_type_every_entry_point():
    assert set(_declarations()) - _UNTYPED == set(_build._SIGNATURES)
