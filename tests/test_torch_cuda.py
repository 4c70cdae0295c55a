"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA card and skips where there is none.  The file
imports no JAX, so it also runs on a machine with PyTorch and a card only:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

(``tests/conftest.py`` imports JAX for the JAX package's tests.)
"""

import ctypes
import json
import pathlib
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from gpuradixsort_tpu_torch import bench as tbench
from gpuradixsort_tpu_torch.config import LANES, PAD_KEY, EngineConfig
from gpuradixsort_tpu_torch.core.table import (
    Column,
    Table,
    int32_bits,
    make_column,
    make_key_column,
)
from gpuradixsort_tpu_torch.kernels import _build
from gpuradixsort_tpu_torch.kernels import aggregate as tkagg
from gpuradixsort_tpu_torch.kernels import bucketize as tbucketize
from gpuradixsort_tpu_torch.kernels import gather as tgather
from gpuradixsort_tpu_torch.kernels import probe as tprobe
from gpuradixsort_tpu_torch.kernels import radix as tradix
from gpuradixsort_tpu_torch.kernels import scan as tscan
from gpuradixsort_tpu_torch.kernels import scatter as tscatter
from gpuradixsort_tpu_torch.kernels import sort_plan as tsort_plan
from gpuradixsort_tpu_torch.ops import aggregate as tagg
from gpuradixsort_tpu_torch.ops import filter as tfilter
from gpuradixsort_tpu_torch.ops import join as tjoin
from gpuradixsort_tpu_torch.ops import sort as tsort
from gpuradixsort_tpu_torch.parallel.launch import run_ops, run_ranks
from gpuradixsort_tpu_torch.utils.timing import card_line, profiled_device_ms
from gpuradixsort_tpu_torch.utils.verify import aggregate_errors, join_oracle, mask_keys

pytestmark = pytest.mark.cuda

CFG = EngineConfig()
REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture
def gen():
    return np.random.default_rng(20170101)


def _keysets(gen, n):
    return {
        "uniform": gen.integers(0, 2**32, n, dtype=np.uint32),
        "lowbits": gen.integers(0, 16, n, dtype=np.uint32),
        "all_equal": np.full(n, 0xDEADBEEF, dtype=np.uint32),
        "max_keys": np.where(
            gen.integers(0, 2, n).astype(bool), np.uint32(0xFFFFFFFF),
            gen.integers(0, 100, n, dtype=np.uint32),
        ),
    }


def _lookback(keys, idx, shift: int, cfg):
    """The look-back pass at ``shift``, unplanned, from a fresh sort_plan of ``keys``."""
    state = tsort_plan.sort_plan(keys, cfg, torch.zeros(1, dtype=torch.int64, device=keys.device))
    return tscatter.bucketize_scatter_lookback(keys, idx, cfg, state, shift // cfg.radix_bits)


def _same(got: torch.Tensor, want: torch.Tensor) -> bool:
    return torch.equal(int32_bits(got), int32_bits(want))


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
def test_kernels_match_plain(bits, card, gen):
    cfg = EngineConfig(radix_bits=bits)
    for keys_np in _keysets(gen, 4 * cfg.block).values():
        keys = torch.from_numpy(keys_np).to(card)
        idx = torch.arange(keys.numel(), dtype=torch.int32, device=card).view(torch.uint32)
        for shift in (0, 4, 28):
            hist = tradix.tile_histograms(keys, shift, cfg, impl="reference")
            assert _same(tradix.tile_histograms(keys, shift, cfg), hist)
            if cfg.radix > 16:
                continue
            ref = tbucketize.bucketize_tiles(keys, idx, shift, cfg, impl="reference")
            got = tbucketize.bucketize_tiles(keys, idx, shift, cfg)
            assert all(_same(g, r) for g, r in zip(got, ref))
            off = tradix.global_offsets(hist)
            ref = tscatter.scatter_runs(*ref, hist, off, cfg, impl="reference")[:2]
            got = tscatter.scatter_runs(*got, hist, off, cfg)[:2]
            assert all(_same(g, r) for g, r in zip(got, ref))
            got = _lookback(keys, idx, shift, cfg)
            assert all(_same(g, r) for g, r in zip(got, ref))
    torch.cuda.synchronize()


@pytest.mark.parametrize("tile_rows", [1, 3, 16])
def test_kernels_at_other_tile_sizes(tile_rows, card, gen):
    # Tiles of 128, 384 and 2048 keys: bucketize runs 1, 3 and 4 chunks.
    cfg = EngineConfig(tile_rows=tile_rows)
    keys = torch.from_numpy(gen.integers(0, 2**32, 2 * cfg.block, dtype=np.uint32)).to(card)
    idx = torch.arange(keys.numel(), dtype=torch.int32, device=card).view(torch.uint32)
    hist = tradix.tile_histograms(keys, 4, cfg, impl="reference")
    assert _same(tradix.tile_histograms(keys, 4, cfg), hist)
    ref = tbucketize.bucketize_tiles(keys, idx, 4, cfg, impl="reference")
    got = tbucketize.bucketize_tiles(keys, idx, 4, cfg)
    assert all(_same(g, r) for g, r in zip(got, ref))
    off = tradix.global_offsets(hist)
    ref = tscatter.scatter_runs(*ref, hist, off, cfg, impl="reference")[:2]
    got = tscatter.scatter_runs(*got, hist, off, cfg)[:2]
    assert all(_same(g, r) for g, r in zip(got, ref))
    got = _lookback(keys, idx, 4, cfg)
    assert all(_same(g, r) for g, r in zip(got, ref))


@pytest.mark.parametrize("tile_rows", [1, 3, 8, 16])
@pytest.mark.parametrize("bits", [1, 2, 4, 8])
def test_hist_and_bucketize_match_plain_at_every_geometry(tile_rows, bits, card, gen):
    # Tile counts that fill no block, one block, and part of the last one;
    # keys at an offset of 4 bytes take K1's route without 16-byte loads.
    cfg = EngineConfig(radix_bits=bits, tile_rows=tile_rows)
    for num_tiles in (1, 8, 8 * 3 + 5):
        n = num_tiles * cfg.tile
        for name, keys_np in _keysets(gen, n + 1).items():
            buf = torch.from_numpy(keys_np).to(card)
            for keys in (buf[:n], buf[1:]):
                idx = torch.arange(n, dtype=torch.int32, device=card).view(torch.uint32)
                for shift in (0, 4, 28):
                    where = f"{name} tiles={num_tiles} shift={shift} offset={keys.data_ptr() % 16}"
                    hist = tradix.tile_histograms(keys, shift, cfg, impl="reference")
                    assert _same(tradix.tile_histograms(keys, shift, cfg), hist), where
                    if cfg.radix > 16:
                        continue
                    ref = tbucketize.bucketize_tiles(keys, idx, shift, cfg, impl="reference")
                    got = tbucketize.bucketize_tiles(keys, idx, shift, cfg)
                    assert all(_same(g, r) for g, r in zip(got, ref)), where
    torch.cuda.synchronize()


@pytest.mark.parametrize("tile_rows", [56, 57, 64, 200])
def test_hist_fields_hold_large_tiles(tile_rows, card, gen):
    # More than 224 keys a lane: K1 drains its 8-bit fields between batches,
    # and equal keys fill one field as fast as keys can.
    for bits in (4, 8):
        cfg = EngineConfig(radix_bits=bits, tile_rows=tile_rows)
        for name, keys_np in _keysets(gen, 3 * cfg.tile).items():
            keys = torch.from_numpy(keys_np).to(card)
            for shift in (0, 28):
                hist = tradix.tile_histograms(keys, shift, cfg, impl="reference")
                assert _same(tradix.tile_histograms(keys, shift, cfg), hist), (name, bits, shift)
    torch.cuda.synchronize()


def test_every_tile_size_launches(card, gen):
    # The C entry points accept the wrappers' geometry at tile_rows 1-16.
    for tile_rows in range(1, 17):
        for bits in (1, 2, 4, 8):
            cfg = EngineConfig(radix_bits=bits, tile_rows=tile_rows)
            keys = torch.from_numpy(gen.integers(0, 2**32, 3 * cfg.tile, dtype=np.uint32)).to(card)
            hist = tradix.tile_histograms(keys, 0, cfg, impl="reference")
            assert _same(tradix.tile_histograms(keys, 0, cfg), hist)
            if cfg.radix <= 16:
                ref = tbucketize.bucketize_tiles(keys, keys, 0, cfg, impl="reference")
                got = tbucketize.bucketize_tiles(keys, keys, 0, cfg)
                assert all(_same(g, r) for g, r in zip(got, ref))
                ref = tscatter.scatter_runs(*ref, hist, tradix.global_offsets(hist), cfg,
                                            impl="reference")[:2]
                assert all(_same(g, r) for g, r in zip(_lookback(keys, keys, 0, cfg), ref))
    torch.cuda.synchronize()


@pytest.mark.parametrize("n", [1000, 3 * CFG.block + 17])
def test_fused_sort_on_card_matches_cpu(n, card, gen):
    for keys in _keysets(gen, n).values():
        before = tscatter.bucketize_scatter_lookback.launches
        s, p = tsort.sort_pairs(keys, CFG, method="fused", device=card)
        assert tscatter.bucketize_scatter_lookback.launches > before
        cs, cp = tsort.sort_pairs(keys, CFG, method="fused", device="cpu")
        np.testing.assert_array_equal(s.data.cpu().numpy(), cs.data.numpy())
        np.testing.assert_array_equal(p.data.cpu().numpy(), cp.data.numpy())
        order = np.argsort(keys, kind="stable")
        np.testing.assert_array_equal(p.to_numpy(), order.astype(np.uint32))


@pytest.mark.parametrize("tile_rows", [1, 3, 16])
def test_destinations_and_scan_match_plain(tile_rows, card, gen):
    for bits in (1, 2, 4, 8):
        cfg = EngineConfig(radix_bits=bits, tile_rows=tile_rows)
        for keys_np in _keysets(gen, 2 * cfg.block).values():
            keys = torch.from_numpy(keys_np).to(card)
            for shift in (0, 4, 28):
                hist = tradix.tile_histograms(keys, shift, cfg, impl="reference")
                off = tradix.global_offsets(hist)
                ref = tradix.tile_destinations(keys, off, shift, cfg, impl="reference")
                before = tradix.tile_destinations.launches
                assert _same(tradix.tile_destinations(keys, off, shift, cfg), ref)
                assert tradix.tile_destinations.launches == before + 1
    for n in (1, 127, 1023, 4097, (1 << 20) + 3):
        for x_np in (gen.integers(0, 100, n).astype(np.int32),
                     gen.integers(-(2**31), 2**31, n).astype(np.int32)):  # wraps
            x = torch.from_numpy(x_np).to(card)
            scan, total = tscan.exclusive_scan(x)
            ref_scan, ref_total = tscan.exclusive_scan(x, impl="reference")
            assert _same(scan, ref_scan) and int(total) == int(ref_total)
    torch.cuda.synchronize()


def _any_radix_cfg(radix: int, tile_rows: int):
    # Any power-of-two radix, including the 8- to 128-bucket ones EngineConfig cannot name.
    return types.SimpleNamespace(radix=radix, tile=tile_rows * LANES, tile_rows=tile_rows)


@pytest.mark.parametrize("tile_rows", [1, 3, 8, 16])
def test_destinations_match_plain_at_every_geometry(tile_rows, card, gen):
    # Radix 2-256 (registers up to 32, the warp's shared table above); tile
    # counts that fill no block, one block, and part of the last one; keys
    # at an offset of 4 bytes.
    for bits in range(1, 9):
        cfg = _any_radix_cfg(1 << bits, tile_rows)
        for num_tiles in (1, 8, 8 * 3 + 5):
            n = num_tiles * cfg.tile
            for name, keys_np in _keysets(gen, n + 1).items():
                buf = torch.from_numpy(keys_np).to(card)
                for keys in (buf[:n], buf[1:]):
                    for shift in (0, 28):
                        where = (f"{name} radix={cfg.radix} tiles={num_tiles} shift={shift} "
                                 f"offset={keys.data_ptr() % 16}")
                        hist = tradix.tile_histograms(keys, shift, cfg, impl="reference")
                        off = tradix.global_offsets(hist)
                        ref = tradix.tile_destinations(keys, off, shift, cfg, impl="reference")
                        assert _same(tradix.tile_destinations(keys, off, shift, cfg), ref), where
    torch.cuda.synchronize()


def _same_bytes(got: torch.Tensor, want: torch.Tensor) -> bool:
    """One dtype and shape, and the same bytes (any element type, NaN payloads too)."""
    return (got.dtype == want.dtype and got.shape == want.shape
            and torch.equal(got.reshape(-1).view(torch.uint8), want.reshape(-1).view(torch.uint8)))


def _moved_columns(gen, n: int, count: int, device) -> list:
    """``count`` contiguous columns of n rows, cycling through the layouts a
    dest_scatter launch moves: 4-byte words, 2-D rows of 16 (one 16-byte
    unit) and 12 bytes (three 4-byte units), 2-, 1- and 8-byte elements."""
    makers = (
        lambda: gen.integers(0, 2**32, n, dtype=np.uint32),
        lambda: gen.integers(-(2**31), 2**31, (n, 4)).astype(np.int32),
        lambda: gen.standard_normal(n).astype(np.float32),
        lambda: gen.integers(-(2**31), 2**31, (n, 3)).astype(np.int32),
        lambda: gen.integers(-(2**15), 2**15, n).astype(np.int16),
        lambda: gen.integers(0, 2, n).astype(bool),
        lambda: gen.integers(-(2**62), 2**62, n, dtype=np.int64),
        lambda: gen.integers(-(2**15), 2**15, (n, 3)).astype(np.int16),
        lambda: gen.standard_normal((n, 2)).astype(np.float32),
    )
    return [torch.from_numpy(makers[i % len(makers)]()).to(device) for i in range(count)]


@pytest.mark.parametrize("tile_rows", [1, 3, 8, 16, 64, 300])
def test_dest_scatter_matches_plain_at_every_geometry(tile_rows, card, gen, monkeypatch):
    # Radix 2-256 (registers up to 32, the tile's row of shared bases
    # above); tile counts at the launch's own geometry (1, 8 and 29 tiles)
    # and, at the largest partition P the tile allows (whatever its runs),
    # P - 1, P, P + 1 and 3P + 1 tiles (a ragged last partition, a whole
    # one, one tile after whole ones); 0, 1, 8 and 9 moved columns (9: two
    # launches) of every layout; rank keys at an offset of 4 bytes; staging
    # past 48 KB a block (16, 64), and one tile a partition (300).
    for bits in range(1, 9):
        cfg = _any_radix_cfg(1 << bits, tile_rows)
        with monkeypatch.context() as m:
            m.setattr(tradix, "DEST_SCATTER_RUN_ROWS", 1 << 30)
            m.setattr(tradix, "DEST_SCATTER_MIN_BLOCKS", 1)
            per_block = tradix.dest_scatter_tiles(cfg, 1)
        edges = [t for t in (per_block - 1, per_block, per_block + 1, 3 * per_block + 1) if t]
        for num_tiles, largest in [(t, False) for t in (1, 8, 29)] + [(t, True) for t in edges]:
            n = num_tiles * cfg.tile
            buf = torch.from_numpy(gen.integers(0, 2**32, n + 1, dtype=np.uint32)).to(card)
            for keys, shift in ((buf[:n], 0), (buf[1:], 28)):
                hist = tradix.tile_histograms(keys, shift, cfg, impl="reference")
                off = tradix.global_offsets(hist)
                for count in (0, 1, 8, 9):
                    cols = _moved_columns(gen, n, count, card)
                    want = tradix.dest_scatter(keys, hist, off, shift, cfg, cols,
                                               impl="reference")
                    with monkeypatch.context() as m:
                        if largest:
                            m.setattr(tradix, "DEST_SCATTER_RUN_ROWS", 1 << 30)
                            m.setattr(tradix, "DEST_SCATTER_MIN_BLOCKS", 1)
                        where = (f"radix={cfg.radix} tiles={num_tiles} geometry="
                                 f"{tradix.dest_scatter_geometry(cfg, num_tiles)} shift={shift} "
                                 f"columns={count}")
                        before = tradix.dest_scatter.launches
                        got = tradix.dest_scatter(keys, hist, off, shift, cfg, cols)
                    assert tradix.dest_scatter.launches - before == -(-count // 8), where
                    assert len(got) == count and all(map(_same_bytes, got, want)), where
    torch.cuda.synchronize()


def _gathered_columns(gen, n: int, device) -> list:
    """Nine columns of n rows: ``_moved_columns``' first seven (1-, 2-, 4- and 8-byte elements, rows of 12 and 16 bytes), text rows
    of 25 bytes, and rows of 4 bytes at an odd address (moved a byte a unit)."""
    text = torch.from_numpy(gen.integers(0, 256, (n, 25), dtype=np.uint8)).to(device)
    odd = torch.from_numpy(gen.integers(0, 256, 4 * n + 1, dtype=np.uint8)).to(device)
    return _moved_columns(gen, n, 7, device) + [text, odd[1:].view(n, 4)]


def _parent_gather(v: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """The route the kernel replaced: index_select of the clipped int64 index."""
    index = src.to(torch.int64).clamp(0, v.shape[0] - 1)
    return int32_bits(v).index_select(0, index).view(v.dtype)


@pytest.mark.parametrize("method", ["fused", "radix", "torch"])
@pytest.mark.parametrize("share", [0.0, 0.01, 0.5, 1.0])
def test_gather_columns_through_a_sorts_permutation(method, share, card, gen):
    # R of each method over a padded buffer of 3 blocks whose live length
    # lies off the block and off the kernel's 128-row run (all of it at
    # 100%): the kernel, which reads R only below the length and writes the
    # rows past it from row 0, equals its plain version and the parent's
    # route over whole output buffers, also where it reads every row; a
    # launch a column.
    padded = 3 * CFG.block
    length = padded if share == 1.0 else int(padded * share) + (3 if share else 0)
    keys = gen.integers(0, 1 << 20, padded, dtype=np.uint32)
    col = Column(torch.from_numpy(keys).to(card), length)
    _, perm = tsort.sort_pairs(col, CFG, method=method)
    assert perm.length == length
    src = int32_bits(perm.data)
    cols = _gathered_columns(gen, padded, card)
    want = [_parent_gather(v, src) for v in cols]
    for live in (length, None):
        before = tgather.gather_columns.launches
        got = tgather.gather_columns(cols, src, live)
        assert tgather.gather_columns.launches - before == len(cols)
        plain = tgather.gather_columns(cols, src, live, impl="reference")
        assert all(map(_same_bytes, got, plain)), live
        assert all(map(_same_bytes, got, want)), live
    torch.cuda.synchronize()


@pytest.mark.parametrize("index_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("n", [1, 127, 129, 4097, 70_001])
def test_gather_columns_clips_any_index(index_dtype, n, card, gen):
    # Indices below 0 and past each column's rows (int64 ones past 2^32 too),
    # columns shorter and longer than the index, the index 4 bytes off its
    # 16-byte alignment (read element by element) and aligned, live lengths
    # at and around the run's edges: the kernel against its plain version,
    # and against the parent's route with the rows past live read as row 0.
    wide = index_dtype == torch.int64
    lo, hi = (-(2**40), 2**40) if wide else (-(2**31), 2**31)
    raw = gen.integers(0, 2 * n + 200, n + 1) - 100
    far = gen.random(n + 1) < 0.05
    raw[far] = gen.integers(lo, hi, int(far.sum()))
    buf = torch.from_numpy(raw).to(index_dtype).to(card)
    for src in (buf[:n], buf[1:]):
        for rows in (50, n + 77):
            cols = [torch.from_numpy(gen.integers(-(2**31), 2**31, rows).astype(np.int32))
                    .to(card),
                    torch.from_numpy(gen.integers(0, 256, (rows, 3), dtype=np.uint8)).to(card)]
            for live in sorted({0, 1, min(n, 127), min(n, 128), min(n, 129), n // 2, n}):
                got = tgather.gather_columns(cols, src, live)
                plain = tgather.gather_columns(cols, src, live, impl="reference")
                read = torch.where(torch.arange(n, device=card) < live, src, 0)
                where = f"n={n} rows={rows} live={live} offset={src.data_ptr() % 16}"
                assert all(map(_same_bytes, got, plain)), where
                assert all(_same_bytes(g, _parent_gather(v, read))
                           for g, v in zip(got, cols)), where
    torch.cuda.synchronize()


def test_gather_columns_refuses_what_it_cannot_read(card):
    src = torch.zeros(8, dtype=torch.int32, device=card)
    col = torch.zeros(8, dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="live must lie"):
        tgather.gather_columns([col], src, 9)
    with pytest.raises(ValueError, match="int32 or int64"):
        tgather.gather_columns([col], src.view(torch.uint32))
    with pytest.raises(ValueError, match="has none"):
        tgather.gather_columns([col[:0]], src)
    with pytest.raises(RuntimeError, match="grs_gather_rows"):  # the output not 16-byte aligned
        _build.launch("grs_gather_rows", src, src.data_ptr(), 4, 8, 8, col.data_ptr(), 8, 1, 4,
                      col.data_ptr() + 4)


@pytest.mark.parametrize("payloads", [1, 8, 9])
@pytest.mark.parametrize("method", ["fused", "radix", "torch"])
def test_sort_table_gathers_by_one_kernel(payloads, method, card, gen, monkeypatch):
    # sort_table of a padded table (a selection's buffer: 700 live rows of 3
    # blocks, stale rows past them) on the card: one gather launch a
    # payload and no index_select (but the torch method's one of its index,
    # the library baseline's), its whole buffers equal to the CPU's.
    padded, length = 3 * CFG.block, 700
    keys = gen.integers(0, 1 << 16, padded, dtype=np.uint32)
    cols = {f"p{i}": c for i, c in enumerate(_gathered_columns(gen, padded, "cpu")[:payloads])}

    def table(device):
        t = {name: Column(c.to(device), length) for name, c in cols.items()}
        return Table({"k": Column(torch.from_numpy(keys).to(device), length), **t})

    want = tsort.sort_table(table("cpu"), "k", CFG, method)
    on_card = table(card)

    selects = []
    index_select = torch.Tensor.index_select

    def counted_index_select(*args, **kwargs):
        selects.append(args[0].shape)
        return index_select(*args, **kwargs)

    monkeypatch.setattr(torch.Tensor, "index_select", counted_index_select)
    monkeypatch.setattr(torch, "index_select", counted_index_select)
    before = tgather.gather_columns.launches
    got = tsort.sort_table(on_card, "k", CFG, method)
    assert tgather.gather_columns.launches - before == payloads
    assert len(selects) == (method == "torch"), selects
    monkeypatch.undo()
    assert got.names() == want.names()
    for name in want.names():
        assert got[name].length == want[name].length, name
        assert _same_bytes(got[name].data.cpu(), want[name].data), name


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_radix_sort_launches_dest_scatter_once_a_pass(bits, card, gen):
    # The radix method's window: K1, K5 and dest_scatter once a pass (twice
    # where more than eight columns move), K4 never, eager, at the capture
    # and at a replay; every result equals the plain version.
    cfg = EngineConfig(radix_bits=bits)
    keys_np = gen.integers(0, 2**32, 3 * cfg.block - 5, dtype=np.uint32)
    col = make_key_column(keys_np, cfg, device=card)
    want = tsort.sort_pairs(keys_np, cfg, method="radix", device="cpu")
    wrappers = (tradix.tile_histograms, tscan.exclusive_scan, tradix.dest_scatter,
                tradix.tile_destinations)
    passes = cfg.num_passes
    tsort.clear_sort_graphs()
    for call in ("first sighting", "capture", "replay"):
        before = [w.launches for w in wrappers]
        got = tsort.sort_pairs(col, cfg, method="radix")
        assert [w.launches - b for w, b in zip(wrappers, before)] == [passes] * 3 + [0], call
        assert all(_same(g.data.cpu(), w.data) for g, w in zip(got, want)), call
    keys = col.data
    carried = tuple(_moved_columns(gen, keys.numel(), 9, card))
    want = tsort._sort_padded(keys.cpu(), tuple(c.cpu() for c in carried), cfg)
    before = [w.launches for w in wrappers]
    got = tsort._sort_padded(keys, carried, cfg)  # 10 columns: two launches a pass
    assert [w.launches - b for w, b in zip(wrappers, before)] == [passes, passes, 2 * passes, 0]
    assert _same(got[0].cpu(), want[0]) and all(map(_same_bytes, (g.cpu() for g in got[1]),
                                                    want[1]))
    tsort.clear_sort_graphs()


def _scatter_input(keys, shift, cfg):
    """K3's input from ``keys``: each tile stably sorted by digit (the plain
    bucketize, a per-tile argsort, which takes any radix), its histograms and
    offsets."""
    idx = torch.arange(keys.numel(), dtype=torch.int32, device=keys.device).view(torch.uint32)
    hist = tradix.tile_histograms(keys, shift, cfg, impl="reference")
    bk, bi = tbucketize._bucketize_ref(keys, idx, shift, cfg)
    return bk, bi, hist, tradix.global_offsets(hist)


def _one_word_off(t: torch.Tensor) -> torch.Tensor:
    """A copy of ``t`` that starts 4 bytes past a 16-byte boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    buf[1:] = t
    return buf[1:]


# More tiles than 64 warps on each of the H100's 132 SMs hold at once, the
# last block of 8 part-filled.
MANY_TILES = 64 * 132 + 37


@pytest.mark.parametrize("tile_rows", [1, 3, 8, 16])
def test_scatter_runs_matches_plain_at_every_geometry(tile_rows, card, gen):
    # Radix 2, 4, 16 (registers at the 1,024-key tile) and 32, 64, 256 (a
    # warp's shared row); 1 tile, 9 (a part-filled last block), and MANY_TILES
    # at radix 16; inputs one word off a 16-byte boundary; exact equality.
    for bits in (1, 2, 4, 5, 6, 8):
        cfg = _any_radix_cfg(1 << bits, tile_rows)
        for num_tiles in (1, 8 + 1) + ((MANY_TILES,) if bits == 4 else ()):
            keys = torch.from_numpy(gen.integers(0, 2**32, num_tiles * cfg.tile,
                                                 dtype=np.uint32)).to(card)
            for shift in (0, 28):
                bk, bi, hist, off = _scatter_input(keys, shift, cfg)
                want = tscatter.scatter_runs(bk, bi, hist, off, cfg, impl="reference")[:2]
                for aligned in (True, False):
                    k, v = (bk, bi) if aligned else (_one_word_off(bk), _one_word_off(bi))
                    where = f"radix={cfg.radix} tiles={num_tiles} shift={shift} aligned={aligned}"
                    before = tscatter.scatter_runs.launches
                    got = tscatter.scatter_runs(k, v, hist, off, cfg)
                    assert tscatter.scatter_runs.launches == before + 1, where
                    assert got[2] is False, where
                    assert all(_same(g, w) for g, w in zip(got[:2], want)), where
    torch.cuda.synchronize()


@pytest.mark.parametrize("tile_rows", [1, 8])
@pytest.mark.parametrize("shift_by", [-5, 7, -(3 * 1024 + 11)])
def test_scatter_runs_drops_destinations_outside_the_buffer_on_card(tile_rows, shift_by, card,
                                                                   gen):
    # Offsets moved by shift_by: an inconsistent pair.  The destinations past
    # either end are dropped, as the plain version drops them; the kernel
    # leaves those rows unwritten where the plain version leaves zeros, so
    # the rows some slot lands on are compared.
    for bits in (1, 4, 8):
        cfg = _any_radix_cfg(1 << bits, tile_rows)
        n = 5 * cfg.tile
        keys = torch.from_numpy(gen.integers(0, 2**32, n, dtype=np.uint32)).to(card)
        bk, bi, hist, off = _scatter_input(keys, 4, cfg)
        moved = off + shift_by
        want = tscatter.scatter_runs(bk, bi, hist, moved, cfg, impl="reference")[:2]
        got = tscatter.scatter_runs(bk, bi, hist, moved, cfg)[:2]
        k = min(abs(shift_by), n)
        written = slice(k, n) if shift_by > 0 else slice(0, n - k)
        assert all(_same(g[written], w[written]) for g, w in zip(got, want)), (cfg.radix, shift_by)
    torch.cuda.synchronize()


def test_scan_unaligned_and_back_to_back(card, gen):
    # Inputs one word off a 16-byte boundary take 4-byte loads; 50 calls of
    # different lengths, back to back on one stream, each equal to the plain
    # version: a status word left by an earlier call would break a later one.
    chunk = tscan.CHUNK
    lengths = [1, 4095, 4096, 4097, chunk - 1, chunk, chunk + 1, 2 * chunk + 1, 33 * chunk,
               (1 << 20) + 3]
    lengths += gen.integers(1, 40 * chunk, 50 - len(lengths)).tolist()
    outs = []
    for n in lengths:
        buf = torch.from_numpy(gen.integers(-(2**31), 2**31, n + 1).astype(np.int32)).to(card)
        x = buf[1:] if n % 2 else buf[:n]
        outs.append((x, *tscan.exclusive_scan(x)))
    for x, scan, total in outs:
        ref_scan, ref_total = tscan.exclusive_scan(x, impl="reference")
        assert _same(scan, ref_scan) and int(total) == int(ref_total), x.numel()


def test_scan_scratch_across_streams_and_graphs(card, gen):
    # Each call clears its own scratch: calls on two streams at once, and a
    # call captured in a CUDA graph (the memset in the graph) and replayed on
    # new data, each equal to the plain version.
    def check(x, got):
        ref_scan, ref_total = tscan.exclusive_scan(x, impl="reference")
        assert _same(got[0], ref_scan) and int(got[1]) == int(ref_total), x.numel()

    xs = [torch.from_numpy(gen.integers(-(2**31), 2**31, n).astype(np.int32)).to(card)
          for n in (3 * tscan.CHUNK + 5, 40 * tscan.CHUNK, 7 * tscan.CHUNK)]
    for x in xs + xs:
        check(x, tscan.exclusive_scan(x))
    streams = [torch.cuda.Stream(card) for _ in range(2)]
    outs = []
    for rep in range(3):
        for stream, x in zip(streams, xs[1:]):
            stream.wait_stream(torch.cuda.current_stream(card))
            with torch.cuda.stream(stream):
                outs.append((stream, x, tscan.exclusive_scan(x)))
    for stream, x, got in outs:
        torch.cuda.current_stream(card).wait_stream(stream)
        check(x, got)
    x = xs[1].clone()
    tscan.exclusive_scan(x)  # built and loaded before the capture
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = tscan.exclusive_scan(x)
    for rep in range(3):
        x.copy_(torch.from_numpy(gen.integers(-(2**31), 2**31, x.numel()).astype(np.int32)))
        graph.replay()
        check(x, got)


def _skewed(gen, n: int) -> np.ndarray:
    """n keys of which about 99% are one key: one digit of every pass holds them."""
    return np.where(gen.random(n) < 0.99, np.uint32(0x5A5A5A5A),
                    gen.integers(0, 2**32, n, dtype=np.uint32)).astype(np.uint32)


@pytest.mark.parametrize("bits", [1, 2, 4])
@pytest.mark.parametrize("n", [1, 3 * CFG.block - 5, 1_000_000, 1 << 24])
def test_sort_plan_matches_plain(bits, n, card, gen):
    # The key read with every pass's digit counts, the plan and the bases
    # beside it, against the plain version: random, low, equal, PAD_KEY-heavy
    # and skewed keys (one key holding 99%, so most lanes of a warp count the
    # same bin of every byte); padded buffers aligned and one word off a
    # 16-byte boundary (a head and a tail of single keys).  The look-back's
    # scratch is clear.
    cfg = EngineConfig(radix_bits=bits)
    for name, keys_np in {**_keysets(gen, n), "skewed": _skewed(gen, n)}.items():
        padded = make_key_column(keys_np, cfg, device=card).data
        for keys in (padded, _one_word_off(padded)):
            skipped = [torch.zeros(1, dtype=torch.int64, device=card) for _ in range(2)]
            before = tsort_plan.sort_plan.launches
            got = tsort_plan.sort_plan(keys, cfg, skipped[0])
            want = tsort_plan.sort_plan(keys, cfg, skipped[1], impl="reference")
            assert tsort_plan.sort_plan.launches == before + 1
            where = (name, keys.data_ptr() % 16)
            assert all(_same(g, w) for g, w in zip(got[:3], want[:3])), where
            assert _same(*skipped) and not got.lookback.any(), where
            assert int(got.counts.sum()) == cfg.num_passes * keys.numel(), where


@pytest.mark.parametrize("tile_rows", [1, 3, 8, 16, 227])
@pytest.mark.parametrize("bits", [1, 2, 4])
def test_lookback_pass_matches_plain_at_every_geometry(tile_rows, bits, card, gen):
    # The look-back pass, unplanned, at radix 2, 4 and 16 and every tile
    # size, and at 227 rows (it cuts the buffer into partitions, not tiles,
    # so the fused sort takes any tile); 1, 8 and 29 tiles and a length
    # that leaves the last 4,096-key partition ragged, and at radix 16 more
    # tiles than the card holds warps at once (up to 16 rows a tile) and
    # more partitions than it holds blocks at once (the last ragged), so
    # that partitions wait on partitions of an earlier wave; inputs aligned
    # and 4 bytes off; the first, a middle and the last pass;
    # random, low, equal, PAD_KEY-heavy and skewed keys.  Each launch takes
    # a fresh sort_plan: a pass index serves once.
    cfg = EngineConfig(radix_bits=bits, tile_rows=tile_rows)
    skipped = torch.zeros(1, dtype=torch.int64, device=card)
    part = tsort_plan.LOOKBACK_PARTITION
    ragged = (3 * part + 5 * cfg.tile) // cfg.tile
    waves = (8 * 132 * 3 + 5) * part // cfg.tile + 1
    many = (MANY_TILES,) if tile_rows <= 16 else ()
    for num_tiles in (1, 8, 29, ragged) + ((*many, waves) if bits == 4 else ()):
        n = num_tiles * cfg.tile
        for name, keys_np in {**_keysets(gen, n + 1), "skewed": _skewed(gen, n + 1)}.items():
            buf = torch.from_numpy(keys_np).to(card)
            pos = torch.from_numpy(gen.permutation(n + 1).astype(np.uint32)).to(card)
            for keys, idx in ((buf[:n], pos[:n]), (buf[1:], pos[1:])):
                for p in (0, cfg.num_passes // 2, cfg.num_passes - 1):
                    state = tsort_plan.sort_plan(keys, cfg, skipped)
                    got = tscatter.bucketize_scatter_lookback(keys, idx, cfg, state, p)
                    want = tscatter.bucketize_scatter_lookback(keys, idx, cfg, state, p,
                                                               impl="reference")
                    where = f"{name} tiles={num_tiles} pass={p} offset={keys.data_ptr() % 16}"
                    assert all(_same(g, w) for g, w in zip(got, want)), where
    torch.cuda.synchronize()


def test_lookback_routes_every_mask_on_card(card, gen):
    # Every mask of 4-bit digits: sort_plan's plan against plan_of_mask,
    # then each pass of the look-back route (input -> R or S, R -> S,
    # S -> R, skipped) against its plain version on copies of the same
    # buffers; the result R against a stable sort, the input unwritten.
    n = 2 * CFG.block
    for mask in range(1 << CFG.num_passes):
        keys = torch.from_numpy(mask_keys(mask, n, CFG, gen)).to(card)
        idx = torch.from_numpy(gen.permutation(n).astype(np.uint32)).to(card)
        held = keys.clone(), idx.clone()
        state = tsort_plan.sort_plan(keys, CFG, torch.zeros(1, dtype=torch.int64, device=card))
        assert state.plan.tolist() == tsort_plan.plan_of_mask(mask, CFG.num_passes), mask
        buffers = tuple((torch.zeros_like(keys), torch.zeros_like(idx)) for _ in range(2))
        for p in range(CFG.num_passes):
            want = tuple(tuple(t.clone() for t in pair) for pair in buffers)
            tscatter.bucketize_scatter_lookback(keys, idx, CFG, state, p, buffers)
            tscatter.bucketize_scatter_lookback(keys, idx, CFG, state, p, want, impl="reference")
            assert all(_same(g, w) for got, w_pair in zip(buffers, want)
                       for g, w in zip(got, w_pair)), (mask, p)
        assert all(_same(g, w) for g, w in zip(buffers[0], _stable_sort(*held))), mask
        assert _same(keys, held[0]) and _same(idx, held[1]), mask


@pytest.mark.parametrize("kind", ["skewed", "2^24 random"])
def test_fused_sort_of_skewed_and_large_inputs(kind, card, gen):
    # The public fused sort, eager, captured and replayed, against numpy:
    # 2^22 keys of which 99% are one key, and 2^24 random keys.
    n = 1 << 22 if kind == "skewed" else 1 << 24
    keys_np = _skewed(gen, n) if kind == "skewed" else gen.integers(0, 2**32, n, dtype=np.uint32)
    col = make_key_column(keys_np, CFG, device=card)
    order = np.argsort(keys_np, kind="stable")
    tsort.clear_sort_graphs()
    for _ in range(3):
        s, p = tsort.sort_pairs(col, CFG, method="fused")
        np.testing.assert_array_equal(s.to_numpy(), keys_np[order])
        np.testing.assert_array_equal(p.to_numpy(), order.astype(np.uint32))
    tsort.clear_sort_graphs()


def test_rejected_lookback_and_count_launches_raise(card):
    # Refused arguments of the three entry points of a fused sort raise, and
    # nothing falls back: a look-back scratch off an 8-byte boundary or too
    # short, no bases, an argument block off an 8-byte boundary or missing,
    # a grid's live rows past the padded keys; counts asked of 8-bit digits;
    # an argument block's length past the padded keys, or a block or keys
    # off their boundaries.
    keys = torch.zeros(CFG.block, dtype=torch.int32, device=card).view(torch.uint32)
    out = torch.empty_like(keys)
    block = tsort_plan.sort_args(tsort_plan.SortArgs(keys, None, (out, out.clone()), 5))
    state = torch.zeros(8192, dtype=torch.int32, device=card)
    n = keys.numel()
    for args, bases, lookback, words, rows in ((block, state, state[1:], 4096, n),
                                               (block, None, state, 4096, n),
                                               (block, state, state, 8, n),
                                               (state[1:], state, state, 4096, n),
                                               (None, state, state, 4096, n),
                                               (block, state, state, 4096, n + 1)):
        with pytest.raises(RuntimeError, match="grs_lookback_scatter"):
            _build.launch("grs_lookback_scatter", keys, tradix.data_ptr(args), None, None, n,
                          rows, 0, CFG.radix, None, 0, CFG.num_passes, tradix.data_ptr(bases),
                          lookback.data_ptr(), words)
    skipped = torch.zeros(1, dtype=torch.int64, device=card)
    for args, bits in ((block, 8), (state[1:], 4)):
        with pytest.raises(RuntimeError, match="grs_sort_plan"):
            _build.launch("grs_sort_plan", keys, args.data_ptr(), keys.numel(), state.data_ptr(),
                          state[2:].data_ptr(), 32 // bits, bits, skipped.data_ptr(),
                          state[2048:].data_ptr(), 4 * 6144)
    for where, length, key_ptr in ((block, keys.numel() + 1, keys.data_ptr()),
                                   (state[1:], 5, keys.data_ptr()),
                                   (block, 5, keys.data_ptr() + 2), (block, 5, None)):
        with pytest.raises(RuntimeError, match="grs_sort_args"):
            _build.launch("grs_sort_args", keys, where.data_ptr(), key_ptr, None,
                          out.data_ptr(), out.data_ptr(), length, keys.numel())
    torch.cuda.synchronize()


def _sort_input(gen, card, n, high):
    """Padded keys below ``high`` and the index column, as sort_pairs makes them."""
    col = make_key_column(gen.integers(0, high, n, dtype=np.uint32), CFG, device=card)
    return col.data, tsort._index_column(col)


def _graphed_passes(keys, idx, cfg=CFG):
    """The fused sort of padded buffers as the graph cache dispatches it."""
    return tsort._fused_sort_padded(keys, idx, cfg)[:2]


def _eager_passes(keys, idx, cfg=CFG, length=None):
    """The fused sort's eager loop on padded buffers, its argument block its own."""
    args = tsort_plan.SortArgs(keys, idx, (torch.empty_like(keys), torch.empty_like(keys)),
                              keys.numel() if length is None else length)
    return tsort._fused_passes(args, cfg, tsort._skip_counter(keys.device))


def _stable_sort(keys, idx):
    """(keys, idx) by torch.sort(stable=True) of the keys widened to int64."""
    order = torch.sort(int32_bits(keys).to(torch.int64) & 0xFFFFFFFF, stable=True).indices
    return int32_bits(keys)[order], int32_bits(idx)[order]


def test_graphed_passes_match_eager(card, gen):
    # Two shapes, each with keys whose digits all vary and keys below 2^12
    # (passes 0-2 run), four calls each with new inputs: the shape's first
    # sighting runs the eager loop, the second captures, every later one
    # replays, whatever digits vary.  The output of the capturing call,
    # held, is not changed by the replays.
    tsort.clear_sort_graphs()
    masks = set()
    for n in (2 * CFG.block, 5 * CFG.block):
        for high in (2**32, 2**12):
            held = None
            for call in range(4):
                keys, idx = _sort_input(gen, card, n, high)
                got = _graphed_passes(keys, idx)
                assert all(_same(g, w) for g, w in
                           zip(got, _eager_passes(keys, idx))), (n, high, call)
                if high == 2**32 and call == 1:
                    held = (got, [g.clone() for g in got])
                masks.add(tsort_plan.pass_mask(keys, CFG))
            if held:
                assert all(_same(a, b) for a, b in zip(*held)), n
    assert masks == {0xFF, 0b111}
    assert len(tsort._SORT_GRAPHS) == 2
    assert [g.replays for g in tsort._SORT_GRAPHS.values()] == [7, 7]
    tsort.clear_sort_graphs()


def test_one_graph_serves_every_varying_digit(card, gen):
    # One padded length, keys whose varying digits differ from call to
    # call (all, passes 0-2, the top two constant, one middle digit, none):
    # one graph, captured at the second call, serves them all.
    n = 3 * CFG.block
    tsort.clear_sort_graphs()
    sets = [gen.integers(0, 2**32, n, dtype=np.uint32), gen.integers(0, 2**12, n, dtype=np.uint32),
            gen.integers(0, 2**24, n, dtype=np.uint32),
            (gen.integers(0, 16, n, dtype=np.uint32) << np.uint32(12)) | np.uint32(0xAB000123),
            np.full(n, 0xDEADBEEF, dtype=np.uint32)]
    masks = []
    for keys_np in sets + sets[:2]:
        keys = torch.from_numpy(keys_np).to(card)
        idx = torch.arange(n, dtype=torch.int32, device=card).view(torch.uint32)
        masks.append(tsort_plan.pass_mask(keys, CFG))
        got = _graphed_passes(keys, idx)
        assert all(_same(g, w) for g, w in zip(got, _stable_sort(keys, idx))), hex(masks[-1])
        assert _same(keys.cpu(), torch.from_numpy(keys_np))  # the input is not written
    assert masks[:5] == [0xFF, 0b111, 0x3F, 0b1000, 0]
    assert len(tsort._SORT_GRAPHS) == 1
    assert next(iter(tsort._SORT_GRAPHS.values())).replays == len(masks) - 1
    tsort.clear_sort_graphs()


def test_skipped_passes_are_counted_on_the_card(card, gen):
    # The plan kernel adds each sort's skipped passes to the device counter,
    # in the eager loop and in every replay.  The pads have no vote: keys
    # below 2^12 skip passes 3-7 with pad rows behind them as without.
    tsort.clear_sort_graphs()
    length = 2 * CFG.block - 5
    keys, idx = _sort_input(gen, card, length, 2**12)
    flat = torch.from_numpy(gen.integers(0, 2**12, 2 * CFG.block, dtype=np.uint32)).to(card)
    before = tsort.skipped_passes()
    for _ in range(3):
        tsort._fused_sort(keys, idx, length, CFG)
        _graphed_passes(flat, idx)  # passes 3-7 constant
    assert tsort.skipped_passes() - before == 3 * 10
    tsort.clear_sort_graphs()


def test_full_graph_cache_runs_the_eager_loop(card, gen, monkeypatch):
    # Once the cache holds GRAPH_CACHE_ENTRIES graphs, a new shape that
    # recurs runs the eager loop: nothing is dropped or captured again.
    monkeypatch.setattr(tsort, "GRAPH_CACHE_ENTRIES", 1)
    tsort.clear_sort_graphs()
    first, second = (_sort_input(gen, card, n, 2**32) for n in (2 * CFG.block, 3 * CFG.block))
    for keys, idx in (first, first, second, second, second):
        got = _graphed_passes(keys, idx)
        assert all(_same(g, w) for g, w in zip(got, _eager_passes(keys, idx)))
    assert [key[1] for key in tsort._SORT_GRAPHS] == [first[0].numel()]
    tsort.clear_sort_graphs()
    assert not tsort._SORT_GRAPHS and not tsort._SEEN


def test_launch_counts_stay_true_under_replay(card, gen):
    # A fused sort is one argument block, one sort_plan and one look-back
    # pass a pass: K1, K5, K2 and K3 are off its path.
    wrappers = (tradix.tile_histograms, tscan.exclusive_scan, tbucketize.bucketize_tiles,
                tscatter.scatter_runs, tscatter.bucketize_scatter_lookback, tsort_plan.sort_plan,
                tsort_plan.sort_args)
    col = make_key_column(gen.integers(0, 2**32, 4 * CFG.block, dtype=np.uint32), CFG,
                          device=card)
    tsort.clear_sort_graphs()

    def launches_of(calls: int) -> list:
        before = [w.launches for w in wrappers]
        for _ in range(calls):
            tsort.sort_pairs(col, CFG, method="fused")
        return [w.launches - b for w, b in zip(wrappers, before)]

    # The first call runs the eager loop; the second captures (which runs
    # nothing) and replays; each later call replays.
    assert launches_of(1) == [0, 0, 0, 0, 8, 1, 1]
    assert launches_of(1) == [0, 0, 0, 0, 8, 1, 1]
    assert launches_of(5) == [0, 0, 0, 0, 40, 5, 5]
    tsort.clear_sort_graphs()


def test_eager_loop_and_replay_make_no_host_sync(card, gen):
    keys, idx = _sort_input(gen, card, 3 * CFG.block, 2**32)
    tsort.clear_sort_graphs()
    _graphed_passes(keys, idx)  # first sighting: the eager loop
    _graphed_passes(keys, idx)  # the capture
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eager = _eager_passes(keys, idx)
        graphed = _graphed_passes(keys, idx)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert all(_same(g, e) for g, e in zip(graphed, eager))
    tsort.clear_sort_graphs()


def test_sort_buffers_never_alias_the_input(card, gen, monkeypatch):
    # The fused sort's result and scratch buffers, recorded at every pass of
    # the eager loop and of the capture, lie apart from each other and from
    # the caller's keys and index, which hold their values after the sort.
    seen = []
    fused_pass = tsort.bucketize_scatter_lookback

    def recording(keys, idx, cfg, state, pass_index, buffers, **live):
        seen.append([(t.data_ptr(), t.data_ptr() + t.nbytes)
                     for t in (keys, idx, *buffers[0], *buffers[1])])
        return fused_pass(keys, idx, cfg, state, pass_index, buffers, **live)

    monkeypatch.setattr(tsort, "bucketize_scatter_lookback", recording)
    tsort.clear_sort_graphs()
    keys, idx = _sort_input(gen, card, 3 * CFG.block, 2**32)
    held = keys.clone(), idx.clone()
    for _ in range(3):  # eager, capture, replay
        out = _graphed_passes(keys, idx)
        assert all(_same(g, w) for g, w in zip(out, _stable_sort(*held)))
        assert _same(keys, held[0]) and _same(idx, held[1])
        assert all(o.data_ptr() not in (keys.data_ptr(), idx.data_ptr()) for o in out)
    assert len(seen) == 2 * CFG.num_passes
    for spans in seen:
        spans = sorted(spans)
        assert all(end <= start for (_, end), (start, _) in zip(spans, spans[1:])), spans
    tsort.clear_sort_graphs()


@pytest.mark.parametrize("method", ["fused", "radix"])
def test_public_sorts_make_no_host_sync(method, card, gen):
    # sort_pairs of a column on the card, at a shape's first sighting (the
    # eager passes) and at a replay, under sync debug mode "error"; the
    # capture, between them, may sync.
    col = make_key_column(gen.integers(0, 2**32, 3 * CFG.block - 5, dtype=np.uint32), CFG,
                          device=card)
    tsort.clear_sort_graphs()
    out = []
    for call in ("first sighting", "capture", "replay"):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("default" if call == "capture" else "error")
        try:
            out.append(tsort.sort_pairs(col, CFG, method=method))
        finally:
            torch.cuda.set_sync_debug_mode("default")
    want = tsort.sort_pairs(col.data.cpu().numpy()[:col.length], CFG, method=method,
                            device="cpu")
    for pair in out:
        assert all(_same(g.data.cpu(), w.data) for g, w in zip(pair, want))
    assert sum(g.replays for g in tsort._SORT_GRAPHS.values()) == 2
    tsort.clear_sort_graphs()


@pytest.mark.parametrize("bits", [4, 8])
def test_radix_replay_matches_eager_and_plain(bits, card, gen):
    # The radix method carrying the index and a 2-D column, and carrying
    # nine columns (ten moved: two dest_scatter launches a pass): its first
    # sighting (eager), its capture and two replays equal the plain version;
    # one graph per carried layout; every pass of every call launched
    # dest_scatter and never K4.
    cfg = EngineConfig(radix_bits=bits)
    n = 4 * cfg.block
    tsort.clear_sort_graphs()
    extra = torch.from_numpy(gen.integers(-(2**31), 2**31, (n, 3)).astype(np.int32))
    wide = tuple(torch.from_numpy(gen.integers(-(2**31), 2**31, n).astype(np.int32))
                 for _ in range(8))
    for call in range(4):
        keys_np = gen.integers(0, 2**32, n, dtype=np.uint32)
        keys = torch.from_numpy(keys_np)
        idx = torch.arange(n, dtype=torch.int32).view(torch.uint32)
        before = (tradix.dest_scatter.launches, tradix.tile_destinations.launches)
        want = tsort._sort_padded(keys, (idx, extra), cfg)
        got = tsort._sort_padded(keys.to(card), (idx.to(card), extra.to(card)), cfg)
        assert _same(got[0].cpu(), want[0]), call
        assert all(_same(g.cpu(), w) for g, w in zip(got[1], want[1])), call
        keys_only = tsort._sort_padded(keys.to(card), (), cfg)
        assert _same(keys_only[0].cpu(), want[0]) and keys_only[1] == ()
        want = tsort._sort_padded(keys, (idx, *wide), cfg)
        got = tsort._sort_padded(keys.to(card), (idx.to(card), *(c.to(card) for c in wide)),
                                 cfg)
        assert _same(got[0].cpu(), want[0]), call
        assert all(_same(g.cpu(), w) for g, w in zip(got[1], want[1])), call
        assert (tradix.dest_scatter.launches - before[0],
                tradix.tile_destinations.launches - before[1]) == (4 * cfg.num_passes, 0), call
    assert {key[4] for key in tsort._SORT_GRAPHS} == {
        ((torch.uint32, ()), (torch.int32, (3,))), (),
        ((torch.uint32, ()), *((torch.int32, ()),) * 8)}
    assert [g.replays for g in tsort._SORT_GRAPHS.values()] == [3, 3, 3]
    tsort.clear_sort_graphs()


def test_wide_carried_rows_run_eagerly(card, gen, monkeypatch):
    # A graph's inputs hold at most GRAPH_MAX_PADDED rows of 8 bytes: at that
    # length the index alone, or no carried column, graphs; the index with a
    # 12-byte column runs eagerly, and its result still equals the plain one.
    n = 4 * CFG.block
    monkeypatch.setattr(tsort, "GRAPH_MAX_PADDED", n)
    tsort.clear_sort_graphs()
    keys = torch.from_numpy(gen.integers(0, 2**32, n, dtype=np.uint32))
    idx = torch.arange(n, dtype=torch.int32).view(torch.uint32)
    extra = torch.from_numpy(gen.integers(-(2**31), 2**31, (n, 3)).astype(np.int32))
    for carried in ((idx,), (), (idx, extra)):
        want = tsort._sort_padded(keys, carried, CFG)
        for _ in range(3):
            got = tsort._sort_padded(keys.to(card), tuple(c.to(card) for c in carried), CFG)
            assert _same(got[0].cpu(), want[0])
            assert all(_same(g.cpu(), w) for g, w in zip(got[1], want[1]))
    assert sorted(len(key[4]) for key in tsort._SORT_GRAPHS) == [0, 1]
    assert [g.replays for g in tsort._SORT_GRAPHS.values()] == [2, 2]
    tsort.clear_sort_graphs()


def test_sorts_on_two_streams_take_turns(card, gen, monkeypatch):
    # Sorts of one padded shape at eight live lengths on two streams share
    # one graph, its argument block and its scratch; each call waits for the
    # last one's replay, so no result mixes.
    cols = [make_key_column(gen.integers(0, 2**32, 64 * CFG.block - 997 * i, dtype=np.uint32),
                            CFG, device=card) for i in range(8)]
    with monkeypatch.context() as m:
        m.setattr(tsort, "GRAPH_MAX_PADDED", 0)
        want = [tsort.sort_pairs(c, CFG, method="fused") for c in cols]
    tsort.clear_sort_graphs()
    tsort.sort_pairs(cols[0], CFG, method="fused")
    tsort.sort_pairs(cols[0], CFG, method="fused")  # captured
    streams = [torch.cuda.Stream(card) for _ in range(2)]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream(card))
    got = []
    for i, col in enumerate(cols * 2):
        with torch.cuda.stream(streams[i % 2]):
            got.append(tsort.sort_pairs(col, CFG, method="fused"))
    torch.cuda.synchronize()
    for i, pair in enumerate(got):
        assert all(_same(g.data, w.data) for g, w in zip(pair, want[i % len(cols)])), i
    assert len(tsort._SORT_GRAPHS) == 1
    tsort.clear_sort_graphs()


def test_clear_sort_graphs_frees_the_pool(card, gen):
    tsort.clear_sort_graphs()
    col = make_key_column(gen.integers(0, 2**32, 64 * CFG.block, dtype=np.uint32), CFG,
                          device=card)
    tsort.sort_pairs(col, CFG, method="fused")  # first sighting: the eager loop
    torch.cuda.empty_cache()
    base = torch.cuda.memory_reserved(card)
    tsort.sort_pairs(col, CFG, method="fused")  # the capture
    torch.cuda.empty_cache()
    # At least the scratch S, keys and index: 8 bytes a key (the input is
    # the caller's and each call's result its own).
    assert torch.cuda.memory_reserved(card) - base >= 8 * col.padded_length
    tsort.clear_sort_graphs()
    torch.cuda.empty_cache()
    assert torch.cuda.memory_reserved(card) <= base


def test_failed_capture_raises(card, gen, monkeypatch):
    # A wrapper that fails during the capture: the call raises, caches
    # nothing and leaves the launch counts as they were; it does not fall
    # back to the eager loop.
    keys, idx = _sort_input(gen, card, 2 * CFG.block, 2**32)
    fused_pass = tsort.bucketize_scatter_lookback

    def failing(*args, **kwargs):
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("refused during capture")
        return fused_pass(*args, **kwargs)

    tsort.clear_sort_graphs()
    _graphed_passes(keys, idx)  # first sighting: the eager loop
    monkeypatch.setattr(tsort, "bucketize_scatter_lookback", failing)
    before = tsort_plan.sort_plan.launches
    with pytest.raises(RuntimeError, match="refused during capture"):
        _graphed_passes(keys, idx)
    assert not tsort._SORT_GRAPHS
    assert tsort_plan.sort_plan.launches == before
    monkeypatch.undo()
    got = _graphed_passes(keys, idx)
    assert len(tsort._SORT_GRAPHS) == 1
    assert all(_same(g, e) for g, e in zip(got, _eager_passes(keys, idx)))
    tsort.clear_sort_graphs()


def _live_lengths(padded: int) -> list:
    """Live lengths of a padded buffer: none, one, a tile less one, a partition less
    one, a partition, one in an earlier partition, one in the last, and all."""
    part = tsort_plan.LOOKBACK_PARTITION
    return [0, 1, CFG.tile - 1, part - 1, part, 2 * part + 17, padded - 5, padded]


def _stale_buffer(gen, padded: int) -> np.ndarray:
    """Random keys, 5% of them PAD_KEY; past a live length they stand for stale rows."""
    buf = gen.integers(0, 2**32, padded, dtype=np.uint32)
    buf[gen.random(padded) < 0.05] = np.uint32(PAD_KEY)
    return buf


@pytest.mark.parametrize("bits", [1, 2, 4])
def test_lookback_at_live_lengths_matches_plain(bits, card, gen):
    # A sort's passes at live lengths inside the last 4,096-key partition,
    # in an earlier one and at a partition's end, the rows past the length
    # stale: sort_plan (plan, counts, bases, skipped passes) and each
    # look-back pass routed by its plan, with the index made and given,
    # against their plain versions on copies of the same buffers; R against
    # a stable sort of the re-padded input.
    cfg = EngineConfig(radix_bits=bits)
    padded = 3 * cfg.block  # six partitions
    for length in _live_lengths(padded):
        keys = torch.from_numpy(_stale_buffer(gen, padded)).to(card)
        for idx in (None, torch.from_numpy(gen.permutation(padded).astype(np.uint32)).to(card)):
            skipped = [torch.zeros(1, dtype=torch.int64, device=card) for _ in range(2)]
            pairs = tuple((torch.zeros_like(keys), torch.zeros_like(keys)) for _ in range(2))
            block = tsort_plan.sort_args(tsort_plan.SortArgs(keys, idx, pairs[0], length))
            state = tsort_plan.sort_plan(keys, cfg, skipped[0], length=length, block=block)
            ref = tsort_plan.sort_plan(keys, cfg, skipped[1], impl="reference", length=length)
            where = (length, idx is None)
            assert all(_same(g, w) for g, w in zip(state[:3], ref[:3])), where
            assert _same(*skipped), where
            for p in range(cfg.num_passes):
                want = tuple(tuple(t.clone() for t in pair) for pair in pairs)
                tscatter.bucketize_scatter_lookback(keys, idx, cfg, state, p, pairs,
                                                    length=length, block=block)
                tscatter.bucketize_scatter_lookback(keys, idx, cfg, ref, p, want, impl="reference",
                                                    length=length)
                assert all(_same(g, w) for got, w_pair in zip(pairs, want)
                           for g, w in zip(got, w_pair)), (*where, p)
            live = tsort_plan.live_input(keys, idx, length)
            assert all(_same(g, w) for g, w in zip(pairs[0], _stable_sort(*live))), where


def _sentinel_pair(keys):
    """A result R (keys, idx) of ``keys``' shape, every row 0x5EED5EED: a sort must write each."""
    return tuple(torch.full(keys.shape, 0x5EED5EED, dtype=torch.int32, device=keys.device)
                 .view(torch.uint32) for _ in range(2))


@pytest.mark.parametrize("where", ["graphed", "eager above GRAPH_MAX_PADDED"])
def test_sorts_kernels_write_every_pad_row(where, card, gen):
    # R filled with a sentinel before each call, so R's pad rows hold
    # (PAD_KEY, PAD_INDEX) only where the sort's own kernels wrote them: one
    # padded shape sorted at live lengths from none to all, its rows past
    # each length stale, the index made and given; the eager loop against
    # torch.sort(stable=True) of the re-padded input, and (within
    # GRAPH_MAX_PADDED) one graph, captured once, replayed at every length
    # against the eager result.  Above GRAPH_MAX_PADDED the eager launches'
    # grid covers the host's live length and a wave of blocks for the pads.
    part = tsort_plan.LOOKBACK_PARTITION
    padded = 3 * CFG.block if where == "graphed" else tsort.GRAPH_MAX_PADDED + CFG.block
    keys = torch.from_numpy(_stale_buffer(gen, padded)).to(card)
    perm = torch.from_numpy(gen.permutation(padded).astype(np.uint32)).to(card)
    held = keys.clone(), perm.clone()
    skipped = tsort._skip_counter(card)
    graph = None
    for length in (0, 1, part - 1, part, part + 1, padded // 2 + 7, padded - 5, padded):
        for idx in (None, perm):
            want = _stable_sort(*tsort_plan.live_input(keys, idx, length))
            args = tsort_plan.SortArgs(keys, idx, _sentinel_pair(keys), length)
            eager = tsort._fused_passes(args, CFG, skipped)
            assert all(_same(g, w) for g, w in zip(eager, want)), (length, idx is None)
            if where == "graphed":
                if graph is None:  # captured after the eager loop has run once
                    graph = tsort._FusedGraph(args._replace(result=_sentinel_pair(keys)), CFG,
                                              skipped)
                got = graph(tsort_plan.SortArgs(keys, idx, _sentinel_pair(keys), length))
                assert all(_same(g, e) for g, e in zip(got, eager)), (length, idx is None)
    assert _same(keys, held[0]) and _same(perm, held[1])
    torch.cuda.synchronize()


def test_one_graph_serves_every_live_length(card, gen):
    # One padded shape at every live length, the rows past it stale: the
    # first call runs eagerly, the second captures, every later one replays
    # the one graph, each result equal to the plain route's on the CPU and
    # the input unwritten.
    padded = 3 * CFG.block
    lengths = _live_lengths(padded)
    tsort.clear_sort_graphs()
    for length in lengths:
        buf = _stale_buffer(gen, padded)
        col = Column(torch.from_numpy(buf).to(card), length)
        got = tsort.sort_pairs(col, CFG, method="fused")
        want = tsort.sort_pairs(Column(torch.from_numpy(buf), length), CFG, method="fused")
        assert all(_same(g.data.cpu(), w.data) for g, w in zip(got, want)), length
        order = np.argsort(buf[:length], kind="stable")
        np.testing.assert_array_equal(got[1].to_numpy(), order.astype(np.uint32))
        assert _same(col.data.cpu(), torch.from_numpy(buf)), length
    assert len(tsort._SORT_GRAPHS) == 1
    assert next(iter(tsort._SORT_GRAPHS.values())).replays == len(lengths) - 1
    tsort.clear_sort_graphs()


def test_results_outlive_the_next_call(card, gen):
    # A replay writes a result of its own: every earlier call's result, the
    # capture's included, holds its sort after the later calls.
    padded = 2 * CFG.block
    cols = [Column(torch.from_numpy(_stale_buffer(gen, padded)).to(card), padded - 301 * i)
            for i in range(5)]
    tsort.clear_sort_graphs()
    outs = [tsort.sort_pairs(col, CFG, method="fused") for col in cols]
    torch.cuda.synchronize()
    for col, out in zip(cols, outs):
        want = tsort.sort_pairs(Column(col.data.cpu(), col.length), CFG, method="fused")
        assert all(_same(g.data.cpu(), w.data) for g, w in zip(out, want)), col.length
    ptrs = {t.data.data_ptr() for out in outs for t in out}
    assert len(ptrs) == 2 * len(outs)  # no two results share a buffer
    assert next(iter(tsort._SORT_GRAPHS.values())).replays == len(cols) - 1
    tsort.clear_sort_graphs()


# The device work a fused sort may do: its three kernels and sort_plan's memset
# (a "Memset" row, or "memset32" inside a graph).
FUSED_ROWS = ("sort_args_kernel", "sort_plan_kernel", "lookback_scatter_kernel", "memset")


def test_fused_sort_runs_only_its_kernels(card, gen, monkeypatch):
    # sort_pairs and sort_keys of a column with stale rows past its length,
    # eager and replayed: the profiler sees the argument kernel, sort_plan's
    # memset and kernel and the look-back passes, and no other device work
    # (no arange, where or compare over the buffer, no copy of keys or
    # index); the wrappers count 1, 1 and a launch a pass a sort.
    padded = 4 * CFG.block
    col = Column(torch.from_numpy(_stale_buffer(gen, padded)).to(card), padded - 777)
    wrappers = (tsort_plan.sort_args, tsort_plan.sort_plan, tscatter.bucketize_scatter_lookback)
    for how in ("eager", "graphed"):
        tsort.clear_sort_graphs()
        if how == "eager":
            monkeypatch.setattr(tsort, "GRAPH_MAX_PADDED", 0)
        else:
            monkeypatch.undo()
            for _ in range(2):  # seen, then captured
                tsort.sort_pairs(col, CFG, method="fused")
        for entry in (tsort.sort_pairs, tsort.sort_keys):
            before = [w.launches for w in wrappers]
            entry(col, CFG, method="fused")
            assert [w.launches - b for w, b in zip(wrappers, before)] == [1, 1, 8], how
            busy, rows = profiled_device_ms(lambda: entry(col, CFG, method="fused"), calls=2)
            assert busy > 0 and rows, how
            other = [row for row in rows if not any(name in row.lower() for name in FUSED_ROWS)]
            assert not other, (how, entry.__name__, other)
    tsort.clear_sort_graphs()


# join_probe's build sides: none, one key, a build held whole in the splitter
# table (about q18's first join; exactly the table's 32,768), one key past its
# capacity (a stride of 8), and q3's lineitem join's 4.4M keys.
PROBE_BUILDS = (0, 1, 600, 32768, 32769, 4_400_000)
# (positions, negate) of an inner, a semi and an anti join.
PROBE_KINDS = {"inner": (True, False), "semi": (False, False), "anti": (False, True)}


def _probe_build(gen, nb: int) -> np.ndarray:
    """``nb`` unique sorted uint32 keys, half at or above 2^31, PAD_KEY among them."""
    keys = np.unique(gen.integers(0, 2**32, nb + nb // 8 + 8, dtype=np.uint32))
    keys = gen.permutation(keys)[:nb]
    if nb > 1:
        keys[0] = PAD_KEY
    return np.sort(keys)


def _probe_keys(gen, n: int, build: np.ndarray, order: str) -> np.ndarray:
    """``n`` probe keys: half hits, misses across all 32 bits, PAD_KEY now and then."""
    keys = gen.integers(0, 2**32, n, dtype=np.uint32)
    if build.size:
        hits = gen.random(n) < 0.5
        keys[hits] = build[gen.integers(0, build.size, int(hits.sum()))]
    keys[gen.random(n) < 0.01] = PAD_KEY
    return np.sort(keys) if order == "sorted" else keys


def _probe_both(keys, live, build, kind):
    positions, negate = PROBE_KINDS[kind]
    before = tprobe.join_probe.launches
    got = tprobe.join_probe(keys, live, build, positions, negate)
    assert tprobe.join_probe.launches - before == (keys.numel() > 0)
    want = tprobe.join_probe(keys, live, build, positions, negate, impl="reference")
    assert (got[0] is None) == (want[0] is None) == (not positions)
    return got, want


@pytest.mark.parametrize("nb", PROBE_BUILDS)
@pytest.mark.parametrize("order", ["sorted", "random"])
@pytest.mark.parametrize("share", [0.01, 0.5, 1.0])
def test_join_probe_matches_its_plain_version(nb, order, share, card, gen):
    # The kernel against its plain version on the card, whole outputs, for an
    # inner, a semi and an anti join: a probe of 2^20 + 77 rows (a ragged
    # last tile), 1%, 50% or all of it live (off the tile), sorted or random
    # keys, stale rows past the length (a selection's dropped rows).
    n = (1 << 20) + 77
    live = n if share == 1.0 else int(n * share) + 13
    build = torch.from_numpy(_probe_build(gen, nb)).to(card)
    keys = _probe_keys(gen, n, build.cpu().numpy(), order)
    keys[live:] = gen.permutation(keys[live:])  # stale, not PAD_KEY
    keys = torch.from_numpy(keys).to(card)
    off = torch.empty(nb + 1, dtype=torch.int32, device=card)[1:]  # 4 bytes off: key by key
    off.copy_(int32_bits(build))
    for kind in PROBE_KINDS:
        for side in (build, off):
            (pos, keep), (want_pos, want_keep) = _probe_both(keys, live, side, kind)
            assert torch.equal(keep, want_keep), (kind, side.data_ptr() % 32)
            assert pos is None or torch.equal(pos, want_pos), (kind, side.data_ptr() % 32)
    torch.cuda.synchronize()


@pytest.mark.parametrize("n", [1, 3, tprobe.TILE_ROWS - 1, tprobe.TILE_ROWS,
                               tprobe.TILE_ROWS + 1, 4 * tprobe.TILE_ROWS + 3])
@pytest.mark.parametrize("nb", [0, 1, 2, 600, 40003])
def test_join_probe_at_the_tiles_edges(n, nb, card, gen):
    # Probes shorter than a tile, a tile and a row either side, each live
    # length from 0 to n at the edges; the build side's keys given as the
    # int32 view and as uint32, the probe's keys 4 bytes off their 16-byte
    # alignment; a build side past the splitter table whose last 8-key
    # sector is ragged; and build sides that end in a run of PAD_KEYs (a semi
    # join's build may repeat keys), where a pad row's position is the run's
    # first.
    build = _probe_build(gen, nb)
    runs = [build, np.append(build, [PAD_KEY] * 3).astype(np.uint32)]
    buf = torch.from_numpy(_probe_keys(gen, n + 1, build, "random")).to(card)
    for b in runs:
        bt = torch.from_numpy(b).to(card)
        for keys in (buf[:n], buf[1:]):
            for live in sorted({0, 1, n // 2, max(n - 1, 0), n}):
                for side in (bt, int32_bits(bt)):
                    for kind in PROBE_KINDS:
                        (pos, keep), (want_pos, want_keep) = _probe_both(keys, live, side, kind)
                        where = f"n={n} nb={b.size} live={live} {kind}"
                        assert torch.equal(keep, want_keep), where
                        assert pos is None or torch.equal(pos, want_pos), where
    torch.cuda.synchronize()


def test_join_probe_refuses_what_it_cannot_read(card):
    keys = torch.zeros(8, dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="live must lie"):
        tprobe.join_probe(keys, 9, keys)
    with pytest.raises(ValueError, match="uint32"):
        tprobe.join_probe(keys.to(torch.int64), 8, keys)
    out = torch.zeros(16, dtype=torch.int32, device=card)
    with pytest.raises(RuntimeError, match="grs_join_probe"):  # keep not 16-byte aligned
        _build.launch("grs_join_probe", keys, keys.data_ptr(), 8, 8, keys.data_ptr(), 8, None,
                      out.data_ptr() + 4, 0)


def test_join_probe_does_not_spill(card):
    # ptxas's report of the kernel, built as the library builds it: no spill.
    src = REPO / "gpuradixsort_tpu_torch" / "csrc" / "join_probe.cu"
    done = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
                           "/dev/null", str(src)], capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stderr
    report = done.stdout + done.stderr
    assert "join_probe_kernel" in report
    spills = [line for line in report.splitlines() if "spill" in line]
    assert spills and all(" 0 bytes spill stores, 0 bytes spill loads" in line
                          for line in spills), report


@pytest.mark.parametrize("how", ["inner", "semi", "anti"])
def test_join_on_card_probes_by_one_kernel(how, card, gen, monkeypatch):
    # join of a chained selection (its rows past the length stale) on the
    # card against the same on the CPU, whole output buffers: one join_probe
    # launch, no torch.searchsorted, and the inner join's payloads gathered
    # through int32 positions.
    n = 3 * CFG.block + 11
    keys = gen.integers(0, 6000, n, dtype=np.uint32)
    keys[gen.random(n) < 0.01] = PAD_KEY
    vals = gen.integers(-(2**31), 2**31, n).astype(np.int32)
    cpu, dev = _table_pair(card, "k", keys, v=vals)
    bkeys = gen.permutation(6000)[:1500].astype(np.uint32)
    bkeys[0] = PAD_KEY
    bcpu, bdev = _table_pair(card, "k", bkeys, bv=gen.integers(0, 99, 1500).astype(np.int32),
                             bw=gen.integers(-9, 9, (1500, 3)).astype(np.int32))

    def chained(t):
        odd = tfilter.filter_table(t, lambda u: u["v"].data % 2 != 0, CFG).to_table()
        return tfilter.filter_table(odd, lambda u: int32_bits(u["k"].data) % 5 != 0,
                                    CFG).to_table()

    probe_cpu, probe_dev = chained(cpu), chained(dev)
    assert 0 < probe_dev.length < probe_dev["k"].padded_length
    want = tjoin.join(probe_cpu, bcpu, "k", how, CFG, validate_unique=True)

    def no_search(*args, **kwargs):
        raise AssertionError("join searched with torch.searchsorted")

    indices = []
    gather = tjoin.gather_columns

    def seen_gather(values, src, live=None, impl=None):
        indices.append(src.dtype)
        return gather(values, src, live, impl)

    monkeypatch.setattr(torch, "searchsorted", no_search)
    monkeypatch.setattr(tjoin, "gather_columns", seen_gather)
    before = tprobe.join_probe.launches
    got = tjoin.join(probe_dev, bdev, "k", how, CFG, validate_unique=True)
    assert tprobe.join_probe.launches - before == 1
    assert indices == ([torch.int32] if how == "inner" else [])
    monkeypatch.undo()
    assert int(got.count) == int(want.count)
    _same_tables(want.table, got.table)


def _table_pair(card, key, keys, **cols):
    """One table on the CPU and the same table on the card."""
    def build(device):
        tbl = Table({name: make_column(v, device=device) for name, v in cols.items()})
        return tbl.with_column(key, make_key_column(keys, device=device))
    return build("cpu"), build(card)


def _same_tables(cpu, on_card, floats=()):
    assert cpu.names() == on_card.names()
    for name in cpu.names():
        a, b = cpu[name], on_card[name]
        assert a.length == b.length, name
        if name in floats:
            np.testing.assert_allclose(b.data.cpu().numpy(), a.data.numpy(), rtol=1e-6)
        else:
            assert _same(b.data.cpu(), a.data), name


def test_operators_on_card_match_cpu(card, gen):
    n = 3 * CFG.block + 11
    keys = gen.integers(0, 2000, n, dtype=np.uint32)
    vals = gen.integers(-(2**31), 2**31, n).astype(np.int32)
    uvals = gen.integers(0, 2**32, n, dtype=np.uint32)
    fvals = gen.standard_normal(n).astype(np.float32)
    cpu, dev = _table_pair(card, "k", keys, v=vals, u=uvals, f=fvals)
    before = (tradix.dest_scatter.launches, tscan.exclusive_scan.launches)
    k4 = tradix.tile_destinations.launches

    pred = lambda t: (int32_bits(t["k"].data) & 3) != 1  # noqa: E731
    a, b = tfilter.filter_table(cpu, pred, CFG), tfilter.filter_table(dev, pred, CFG)
    assert int(a.count) == int(b.count)
    _same_tables(a.table, b.table)
    # Nine columns, one 2-D and one of bools: two dest_scatter launches.
    wide = {f"c{i}": c.cpu().numpy() for i, c in enumerate(_moved_columns(gen, n, 8, "cpu"))}
    wcpu, wdev = _table_pair(card, "k", keys, **wide)
    launched = tradix.dest_scatter.launches
    a, b = tfilter.filter_table(wcpu, pred, CFG), tfilter.filter_table(wdev, pred, CFG)
    assert tradix.dest_scatter.launches - launched == 2
    assert int(a.count) == int(b.count)
    _same_tables(a.table, b.table)

    aggs = {"s": ("v", "sum"), "c": ("v", "count"), "lo": ("u", "min"), "hi": ("u", "max"),
            "fl": ("f", "min"), "m": ("v", "mean"), "fs": ("f", "sum")}
    launched = tkagg.segment_aggregate.launches
    a, b = tagg.group_by_aggregate(cpu, "k", aggs, CFG), tagg.group_by_aggregate(dev, "k", aggs, CFG)
    assert tkagg.segment_aggregate.launches == launched + 1  # the card's group-by, one launch
    assert int(a.count) == int(b.count)
    _same_tables(a.table, b.table, floats=("m", "fs"))

    bkeys = gen.permutation(4000)[:1500].astype(np.uint32)
    bcpu, bdev = _table_pair(card, "k", bkeys, bv=gen.integers(0, 99, 1500).astype(np.int32))
    for how in ("inner", "semi", "anti"):
        a = tjoin.join(cpu, bcpu, "k", how, CFG, validate_unique=True)
        b = tjoin.join(dev, bdev, "k", how, CFG, validate_unique=True)
        assert int(a.count) == int(b.count)
        _same_tables(a.table, b.table)

    dkeys = gen.integers(0, 3000, 2500, dtype=np.uint32)  # duplicates and misses
    dcpu, ddev = _table_pair(card, "k", dkeys, bv=np.arange(2500, dtype=np.int32))
    a = tjoin.join_expand(cpu, dcpu, "k", CFG, capacity=4 * n)
    b = tjoin.join_expand(dev, ddev, "k", CFG, capacity=4 * n)
    assert int(a.count) == int(b.count) and not bool(b.overflow)
    _same_tables(a.table, b.table)

    for bits in (2, 8):
        cfg = EngineConfig(radix_bits=bits)
        a = tsort.sort_pairs(keys, cfg, method="radix", device="cpu")
        b = tsort.sort_pairs(keys, cfg, method="radix", device=card)
        assert all(_same(y.data.cpu(), x.data) for x, y in zip(a, b))
    after = (tradix.dest_scatter.launches, tscan.exclusive_scan.launches)
    assert all(x > y for x, y in zip(after, before))
    assert tradix.tile_destinations.launches == k4


def test_torch_method_on_card(card, gen):
    keys = gen.integers(0, 50, size=CFG.block + 3, dtype=np.uint32)
    s, p = tsort.sort_pairs(keys, CFG, method="fused", device=card)
    s2, p2 = tsort.sort_pairs(keys, CFG, method="torch", device=card)
    assert _same(s.data, s2.data) and _same(p.data, p2.data)


def test_rejected_launch_raises(card):
    # A block of 2048 threads exceeds the limit of 1024: the entry point
    # returns an error code without launching, and the wrapper raises.
    keys = torch.zeros(CFG.block, dtype=torch.int32, device=card).view(torch.uint32)
    out = torch.empty_like(keys)
    with pytest.raises(RuntimeError, match="grs_bucketize"):
        _build.launch(
            "grs_bucketize", keys, keys.data_ptr(), keys.data_ptr(), out.data_ptr(),
            out.data_ptr(), CFG.block // CFG.tile, CFG.tile, 2048, 0, CFG.radix,
        )
    # A chunk other than the scan kernel's is refused, as is an output off a
    # 16-byte boundary.
    x = torch.zeros(5000, dtype=torch.int32, device=card)
    out = torch.empty(5002, dtype=torch.int32, device=card)
    scratch = torch.zeros(tscan.scratch_words(5000), dtype=torch.int64, device=card)
    for chunk, at in ((1000, 0), (tscan.CHUNK, 1)):
        with pytest.raises(RuntimeError, match="grs_exclusive_scan"):
            _build.launch("grs_exclusive_scan", x, x.data_ptr(), out[at:].data_ptr(), 5000,
                          chunk, scratch.data_ptr())


def test_rejected_dest_scatter_launch_raises(card):
    # Nine column descriptors (a launch takes eight), a unit of 3 bytes, a
    # tile whose staging exceeds a block's shared memory, a block of two
    # warps for a partition of 4 tiles (one warp a tile), a partition of 16
    # tiles (at most 8) and one of 5 tiles of 2^14 rows (more than 2^16
    # rows): the entry point launches nothing and the wrapper's launch
    # raises.
    cfg = EngineConfig()
    keys = torch.zeros(cfg.block, dtype=torch.int32, device=card).view(torch.uint32)
    tables = torch.zeros((cfg.block // cfg.tile, cfg.radix), dtype=torch.int32, device=card)
    out = torch.empty_like(keys)
    good = (keys.data_ptr(), out.data_ptr(), 1, 4)
    for columns, tile, threads, per_block in (
            ([good] * 9, cfg.tile, 32, 1), ([(*good[:3], 3)], cfg.tile, 32, 1),
            ([good], 312 * 128, 32, 1), ([good], cfg.tile, 64, 4), ([good], cfg.tile, 512, 16),
            ([good], 128 * 128, 160, 5)):
        words = (ctypes.c_int64 * (4 * len(columns)))(*(w for c in columns for w in c))
        with pytest.raises(RuntimeError, match="grs_radix_dest_scatter"):
            _build.launch("grs_radix_dest_scatter", keys, keys.data_ptr(), tables.data_ptr(),
                          tables.data_ptr(), ctypes.addressof(words), len(columns),
                          cfg.block // tile, tile, threads, per_block, 0, cfg.radix)


def _dist_sort_calls(gen, n):
    keys = gen.integers(0, 2**32, n, dtype=np.uint32)
    return keys, [{"op": "sort", "inputs": {"keys": keys}, "kwargs": {"cfg": CFG, **kw},
                   "shards": False, "gather": True} for kw in ({}, {"overlap": True})]


def test_dist_sort_two_gloo_ranks_on_card(card, gen):
    _build.library()  # the ranks load this build; they do not rebuild
    keys, calls = _dist_sort_calls(gen, 2 * 4 * CFG.block)
    ranks = run_ranks(2, run_ops, (calls,), "gloo", "cuda:0", timeout=300.0)
    for schedule in range(2):
        by_shard = sorted((r[schedule] for r in ranks), key=lambda x: x["shard"])
        out_k, out_i = by_shard[0]["gathered"]
        np.testing.assert_array_equal(out_k, np.sort(keys))
        np.testing.assert_array_equal(out_i, np.argsort(keys, kind="stable").astype(np.uint32))
        for x in by_shard:
            assert x["transport"] == "gloo via host" and not x["overflow"]
            assert all(x["launches"][k] > 0
                       for k in ("radix_hist", "dest_scatter", "exclusive_scan"))
            assert x["launches"]["radix_dest"] == 0


def test_dist_join_one_nccl_rank(card, gen):
    _build.library()
    n = 3 * CFG.block
    pk = gen.integers(0, 5000, n, dtype=np.uint32)
    bk = gen.integers(0, 5000, n, dtype=np.uint32)  # duplicates on both sides
    pv = gen.integers(0, 2**31 - 1, n, dtype=np.int32)
    bv = gen.integers(0, 2**31 - 1, n, dtype=np.int32)
    calls = [{"op": "join", "inputs": {"probe_keys": pk, "probe_values": pv,
                                       "build_keys": bk, "build_values": bv},
              "kwargs": {"cfg": CFG}, "gather": True}]
    (result,), = run_ranks(1, run_ops, (calls,), "nccl", "cuda:0", timeout=300.0)
    assert result["transport"] == "nccl" and not result["overflow"]
    assert result["launches"]["dest_scatter"] > 0 and result["launches"]["radix_dest"] == 0
    for got, want in zip(result["gathered"], join_oracle(pk, pv, bk, bv)):
        np.testing.assert_array_equal(got, want)


def test_bench_at_1m_checks_every_result(card, tmp_path):
    # The bench module as a user runs it, at its headline size: each method
    # checked before and after its timing, the table sort likewise.
    done = subprocess.run([sys.executable, "-m", "gpuradixsort_tpu_torch.bench", "--sizes",
                           "1000000", "--out", str(tmp_path)],
                          capture_output=True, text=True, timeout=600, cwd=REPO)
    assert done.returncode == 0, done.stderr[-4000:]
    # Each method before and after its timing, the fused sort's skip count
    # agreeing between them, and the table sort before and after its timing.
    assert done.stderr.count("PASS  n=1000000") == 2 * 3 + 1 + 2
    line = json.loads(done.stdout.splitlines()[-1])
    name, limit = (s.strip() for s in card_line().rsplit(",", 1))
    assert line["device"] == {"name": name, "power_limit": limit}
    assert line["value"] > 0 and line["vs_baseline"] > 0
    durations = (tmp_path / "durations_cuda.txt").read_text().splitlines()
    assert durations[0] == card_line() and len(durations) == 3 + len(tbench.STAGES)


# segment_aggregate: the group-by's kernel against its plain version.  Keys,
# the count, integers, min and max must be equal (NaN where NaN); float sums
# and means within one float32 ulp: both add in float64 and round once, in
# another order.
AGG_PATTERNS = ("random", "all_equal", "all_unique", "pad_run", "partition_runs", "thread_runs")
AGG_SHAPES = {"one_partition": (tkagg.PARTITION, tkagg.PARTITION - 333),
              "ragged_last_partition": (3 * tkagg.PARTITION + 1235, 3 * tkagg.PARTITION + 1218),
              "several_waves": (1 << 22, (1 << 22) - 5000)}


def _agg_keys(gen, pattern: str, padded: int, n_live: int) -> np.ndarray:
    """padded sorted keys, the first n_live live, the rest PAD_KEY."""
    row = np.arange(n_live, dtype=np.int64)
    live = {
        "random": lambda: gen.integers(0, max(n_live // 10, 1), n_live, dtype=np.uint32),
        "all_equal": lambda: np.full(n_live, 0xDEADBEEF, dtype=np.uint32),
        "all_unique": lambda: (row * 977 + 5).astype(np.uint32),
        "pad_run": lambda: np.where(gen.random(n_live) < 0.3, np.uint32(PAD_KEY),
                                    gen.integers(0, 1000, n_live, dtype=np.uint32)),
        # Every run ends on the last row of a partition, or of a thread's rows.
        "partition_runs": lambda: (row // tkagg.PARTITION).astype(np.uint32),
        "thread_runs": lambda: (row // 16).astype(np.uint32),
    }[pattern]()
    keys = np.full(padded, PAD_KEY, dtype=np.uint32)
    keys[:n_live] = np.sort(live)
    return keys


def _agg_inputs(gen, padded: int, dev) -> list:
    """Every kind on an int32, a uint32 and a float32 column with NaNs, and a count: 14
    aggregates, two launches."""
    i32 = np.where(gen.random(padded) < 0.1, gen.integers(0, 1000, padded),
                   gen.integers(-(2**31), 2**31, padded)).astype(np.int32)
    u32 = gen.integers(0, 2**32, padded, dtype=np.uint32)
    f32 = gen.standard_normal(padded).astype(np.float32)
    f32[gen.random(padded) < 0.001] = np.nan
    cols = {name: torch.from_numpy(v).to(dev) for name, v in (("i", i32), ("u", u32), ("f", f32))}
    return [(f"{c}_{kind}", cols[c], kind) for c in cols
            for kind in ("sum", "min", "max", "mean")] + [("n", None, "count"), ("n2", None, "count")]


def _assert_agg_close(got, want, inputs) -> None:
    kinds = {name: kind for name, _, kind in inputs}
    for name, (err, ulps) in aggregate_errors(got, want).items():
        if kinds.get(name) in ("sum", "mean") and got[1][name].dtype == torch.float32:
            assert ulps <= 1, (name, err, ulps)
        else:
            assert err == 0 and ulps == 0, (name, err, ulps)


def _agg_matches_plain(keys: torch.Tensor, n_live, inputs, rows=None) -> int:
    """segment_aggregate on the card against its plain version; returns its launches."""
    want = tkagg.segment_aggregate(keys, n_live, inputs, rows, impl="reference")
    before = tkagg.segment_aggregate.launches
    got = tkagg.segment_aggregate(keys, n_live, inputs, rows, impl="cuda")
    torch.cuda.synchronize()
    _assert_agg_close(got, want, inputs)
    return tkagg.segment_aggregate.launches - before


@pytest.mark.parametrize("pattern", AGG_PATTERNS)
@pytest.mark.parametrize("shape", list(AGG_SHAPES))
def test_segment_aggregate_matches_plain(shape, pattern, card, gen):
    padded, n_live = AGG_SHAPES[shape]
    keys = torch.from_numpy(_agg_keys(gen, pattern, padded, n_live)).to(card)
    inputs = _agg_inputs(gen, padded, card)
    assert _agg_matches_plain(keys, n_live, inputs) == 2  # 14 aggregates: 8, then 6


def _agg_rows(gen, padded: int, n_live: int, dev) -> torch.Tensor:
    """A sort's permutation as the group-by hands it on: int32, -1 on the pad rows."""
    rows = gen.permutation(padded).astype(np.int32)
    rows[n_live:] = -1
    return torch.from_numpy(rows).to(dev)


@pytest.mark.parametrize("pattern", AGG_PATTERNS)
@pytest.mark.parametrize("shape", list(AGG_SHAPES))
def test_segment_aggregate_with_rows_matches_plain(shape, pattern, card, gen):
    padded, n_live = AGG_SHAPES[shape]
    keys = torch.from_numpy(_agg_keys(gen, pattern, padded, n_live)).to(card)
    inputs = _agg_inputs(gen, padded, card)
    rows = _agg_rows(gen, padded, n_live, card)
    assert _agg_matches_plain(keys, n_live, inputs, rows) == 2


def test_segment_aggregate_with_rows_of_other_lengths(card, gen):
    # Columns longer and shorter than the keys, read through rows that are
    # no permutation, some out of the columns' range (clamped) and -1.
    padded = 3 * tkagg.PARTITION + 1235
    keys = torch.from_numpy(_agg_keys(gen, "random", padded, padded - 17)).to(card)
    cols = [torch.from_numpy(gen.integers(-(2**31), 2**31, m).astype(np.int32)).to(card)
            for m in (2 * padded + 5, 1000)]
    inputs = [(f"{i}_{kind}", c, kind) for i, c in enumerate(cols)
              for kind in ("sum", "min", "max", "mean")]
    rows = torch.from_numpy(gen.integers(-3, 2 * padded + 9, padded).astype(np.int32)).to(card)
    assert _agg_matches_plain(keys, padded - 17, inputs, rows) == 1


@pytest.mark.parametrize("on_card", [False, True])
@pytest.mark.parametrize("n_live", ["zero", "one", "padded", "inside_a_group"])
def test_segment_aggregate_live_lengths_on_card(n_live, on_card, card, gen):
    padded = 3 * tkagg.PARTITION + 1235
    keys_np = np.sort(gen.integers(0, 50, padded, dtype=np.uint32))
    n = {"zero": 0, "one": 1, "padded": padded,
         "inside_a_group": int(np.searchsorted(keys_np, keys_np[padded // 2])) + 3}[n_live]
    live = torch.tensor(n, dtype=torch.int32, device=card) if on_card else n
    inputs = _agg_inputs(gen, padded, card)[:8]
    assert _agg_matches_plain(torch.from_numpy(keys_np).to(card), live, inputs) == 1


def test_segment_aggregate_reads_its_live_length_on_the_card(card, gen):
    # A 0-d n_live on the card: neither the kernel's route nor the group-by
    # step after a compaction synchronises with the host.
    padded = 2 * tkagg.PARTITION + 99
    keys = torch.from_numpy(_agg_keys(gen, "random", padded, padded - 700)).to(card)
    inputs = _agg_inputs(gen, padded, card)[:8]
    live = torch.tensor(padded - 700, dtype=torch.int32, device=card)
    _build.library()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = tagg.aggregate_sorted_flat(keys, live, inputs)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    _assert_agg_close(got, tkagg.segment_aggregate(keys, padded - 700, inputs, impl="reference"),
                      inputs)


def test_segment_aggregate_with_rows_makes_no_host_sync(card, gen):
    # The group-by's step reads its columns through the sort's permutation,
    # its live length a 0-d tensor on the card: no host sync.
    padded = 2 * tkagg.PARTITION + 99
    keys = torch.from_numpy(_agg_keys(gen, "random", padded, padded - 700)).to(card)
    inputs = _agg_inputs(gen, padded, card)[:8]
    rows = _agg_rows(gen, padded, padded - 700, card)
    live = torch.tensor(padded - 700, dtype=torch.int32, device=card)
    _build.library()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = tagg.aggregate_sorted_flat(keys, live, inputs, rows)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    _assert_agg_close(got, tkagg.segment_aggregate(keys, padded - 700, inputs, rows,
                                                   impl="reference"), inputs)


def test_group_by_on_card_launches_one_kernel_and_gathers_nothing(card, gen, monkeypatch):
    # The card's group-by reads its value columns through the permutation:
    # one segment_aggregate launch, and no gather_rows on its path.
    n = 5 * tkagg.PARTITION + 77
    keys = gen.integers(0, 3000, n, dtype=np.uint32)
    cpu, dev = _table_pair(card, "k", keys, v=gen.integers(-(2**31), 2**31, n).astype(np.int32),
                           f=gen.standard_normal(n).astype(np.float32))
    aggs = {"s": ("v", "sum"), "c": ("v", "count"), "lo": ("v", "min"), "hi": ("f", "max"),
            "m": ("f", "mean")}
    want = tagg.group_by_aggregate(cpu, "k", aggs, CFG)

    def no_gather(*args, **kwargs):
        raise AssertionError("the card's group-by gathered a column")

    monkeypatch.setattr(tkagg, "gather_rows", no_gather)
    monkeypatch.setattr(tsort, "gather_rows", no_gather)
    monkeypatch.setattr(tsort, "gather_columns", no_gather)
    for method in ("fused", "radix"):
        launched = tkagg.segment_aggregate.launches
        got = tagg.group_by_aggregate(dev, "k", aggs, CFG, method)
        assert tkagg.segment_aggregate.launches == launched + 1, method
        assert int(got.count) == int(want.count)
        _same_tables(want.table, got.table, floats=("m",))


def test_segment_aggregate_plain_version_propagates_nan(card):
    # The plain version's float min and max on the card: a NaN wins, as in
    # jnp.minimum / jnp.maximum and on the CPU.
    keys = torch.tensor([1, 1, 1, 2, 2, 3], dtype=torch.int32).view(torch.uint32)
    vals = torch.tensor([0.5, float("nan"), -1.0, 2.0, 3.0, float("nan")])
    inputs = [("lo", vals, "min"), ("hi", vals, "max"), ("s", vals, "sum")]
    cpu = tkagg.segment_aggregate(keys, 6, inputs)
    on_card = [(n, v.to(card), k) for n, v, k in inputs]
    for impl in ("reference", "cuda"):
        got = tkagg.segment_aggregate(keys.to(card), 6, on_card, impl=impl)
        assert all(e == (0.0, 0) for e in aggregate_errors(got, cpu).values()), impl
    assert torch.isnan(cpu[1]["lo"][[0, 2]]).all() and cpu[1]["hi"][1] == 3.0
