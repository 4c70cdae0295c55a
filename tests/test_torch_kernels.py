"""The port's kernel modules against the JAX package's kernels, element for element.

On the CPU each wrapper runs its plain PyTorch version, which is held here
against the JAX package's jnp reference (``impl="reference"``) and, at one
small shape each, against the Pallas kernel body itself
(``impl="interpret"``), as ``tests/test_kernel_parity.py`` runs it.  The
port's tables are (tiles, radix); the JAX package's are padded to 128 lanes,
so the comparisons take its first ``radix`` columns.
"""

import pathlib
import re
import types
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpuradixsort_tpu.config import EngineConfig as JaxConfig
from gpuradixsort_tpu.kernels import bucketize as jbucketize
from gpuradixsort_tpu.kernels import radix as jradix
from gpuradixsort_tpu.kernels import scan as jscan
from gpuradixsort_tpu.kernels import scatter as jscatter
from gpuradixsort_tpu.ops import permute as jpermute
from gpuradixsort_tpu_torch.config import LANES, EngineConfig
from gpuradixsort_tpu_torch.core.table import int32_bits, make_key_column
from gpuradixsort_tpu_torch.kernels import bucketize as tbucketize
from gpuradixsort_tpu_torch.kernels import radix as tradix
from gpuradixsort_tpu_torch.kernels import scan as tscan
from gpuradixsort_tpu_torch.kernels import scatter as tscatter
from gpuradixsort_tpu_torch.kernels import sort_plan as tsort_plan

torch.set_num_threads(1)

SHIFTS = [0, 4, 28]


def _keysets(rng, n):
    return {
        "uniform": rng.integers(0, 2**32, n, dtype=np.uint32),
        "lowbits": rng.integers(0, 16, n, dtype=np.uint32),
        "all_equal": np.full(n, 0xDEADBEEF, dtype=np.uint32),
        "max_keys": np.where(
            rng.integers(0, 2, n).astype(bool), np.uint32(0xFFFFFFFF),
            rng.integers(0, 100, n, dtype=np.uint32),
        ),
    }


def _both(keys_np, idx_np=None):
    """The same keys as a JAX (rows, 128) view and a port 1-D tensor."""
    if idx_np is None:
        idx_np = np.arange(keys_np.size, dtype=np.uint32)
    return (
        jnp.asarray(keys_np).reshape(-1, LANES),
        jnp.asarray(idx_np).reshape(-1, LANES),
        torch.from_numpy(keys_np.copy()),
        torch.from_numpy(idx_np.copy()),
    )


def _eq(got: torch.Tensor, want):
    want = np.asarray(want)
    got = got.numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want.reshape(got.shape))


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
@pytest.mark.parametrize("shift", SHIFTS)
def test_histograms_and_offsets_match_jax(bits, shift, rng):
    cfg, jcfg = EngineConfig(radix_bits=bits), JaxConfig(radix_bits=bits)
    for name, keys in _keysets(rng, 2 * cfg.block).items():
        jk, _, tk, _ = _both(keys)
        jhist = jradix.tile_histograms(jk, shift, jcfg, impl="reference")
        thist = tradix.tile_histograms(tk, shift, cfg)
        assert thist.shape == (2 * cfg.block // cfg.tile, cfg.radix)
        _eq(thist, np.asarray(jhist)[:, : cfg.radix])
        _eq(tradix.global_offsets(thist),
            np.asarray(jradix.global_offsets(jhist))[:, : cfg.radix])


@pytest.mark.parametrize("bits", [1, 2, 4])
@pytest.mark.parametrize("shift", SHIFTS)
def test_bucketize_matches_jax(bits, shift, rng):
    cfg, jcfg = EngineConfig(radix_bits=bits), JaxConfig(radix_bits=bits)
    for name, keys in _keysets(rng, 2 * cfg.block).items():
        idx = rng.permutation(keys.size).astype(np.uint32)
        jk, ji, tk, ti = _both(keys, idx)
        jbk, jbi = jbucketize.bucketize_tiles(jk, ji, shift, jcfg, impl="reference")
        tbk, tbi = tbucketize.bucketize_tiles(tk, ti, shift, cfg)
        _eq(tbk, jbk)
        _eq(tbi, jbi)


@pytest.mark.parametrize("bits", [1, 2, 4])
@pytest.mark.parametrize("shift", SHIFTS)
def test_scatter_runs_matches_jax(bits, shift, rng):
    cfg, jcfg = EngineConfig(radix_bits=bits), JaxConfig(radix_bits=bits)
    for name, keys in _keysets(rng, 4 * cfg.block).items():
        jk, ji, _, _ = _both(keys)
        jhist = jradix.tile_histograms(jk, shift, jcfg, impl="reference")
        joff = jradix.global_offsets(jhist)
        jbk, jbi = jbucketize.bucketize_tiles(jk, ji, shift, jcfg, impl="reference")
        jok, joi, joverflow = jscatter.scatter_runs(
            jbk, jbi, jhist, joff, jcfg, window_rows=cfg.tile_rows, impl="reference")
        assert not bool(joverflow)
        tok, toi, overflow = tscatter.scatter_runs(
            torch.from_numpy(np.array(jbk).reshape(-1)),
            torch.from_numpy(np.array(jbi).reshape(-1)),
            torch.from_numpy(np.asarray(jhist)[:, : cfg.radix].copy()),
            torch.from_numpy(np.asarray(joff)[:, : cfg.radix].copy()),
            cfg,
        )
        assert overflow is False
        _eq(tok, jok)
        _eq(toi, joi)
        # One pass sorts stably by the digit.
        digit = (keys >> np.uint32(shift)) & np.uint32(cfg.radix - 1)
        order = np.argsort(digit, kind="stable")
        np.testing.assert_array_equal(tok.numpy(), keys[order])
        np.testing.assert_array_equal(toi.numpy(), order.astype(np.uint32))


def test_plain_versions_match_pallas_interpret(rng):
    # The Pallas kernel bodies themselves, at one small shape each.
    cfg, jcfg = EngineConfig(), JaxConfig()
    keys = rng.integers(0, 2**32, cfg.block, dtype=np.uint32)
    jk, _, tk, _ = _both(keys)
    jhist = jradix.tile_histograms(jk, 8, jcfg, impl="interpret")
    _eq(tradix.tile_histograms(tk, 8, cfg), np.asarray(jhist)[:, : cfg.radix])

    cfg2, jcfg2 = EngineConfig(radix_bits=2), JaxConfig(radix_bits=2)
    jk, ji, tk, ti = _both(keys)
    jhist = jradix.tile_histograms(jk, 0, jcfg2, impl="reference")
    joff = jradix.global_offsets(jhist)
    jbk, jbi = jbucketize.bucketize_tiles(jk, ji, 0, jcfg2, impl="reference")
    jok, joi, _ = jscatter.scatter_runs(
        jbk, jbi, jhist, joff, jcfg2, window_rows=cfg2.tile_rows, impl="interpret")
    thist = tradix.tile_histograms(tk, 0, cfg2)
    tbk, tbi = tbucketize.bucketize_tiles(tk, ti, 0, cfg2)
    tok, toi, _ = tscatter.scatter_runs(tbk, tbi, thist, tradix.global_offsets(thist), cfg2)
    _eq(tok, jok)
    _eq(toi, joi)


def _jax_fused_pass(keys, idx, shift, cfg, impl):
    """The JAX package's fused pass: scatter_runs(bucketize_tiles(...)) with its tables.

    Returns (hist, offsets) as the port's (tiles, radix) tables, then the
    output keys and indices.
    """
    jcfg = JaxConfig(radix_bits=cfg.radix_bits, tile_rows=cfg.tile_rows)
    jk, ji, _, _ = _both(keys, idx)
    jhist = jradix.tile_histograms(jk, shift, jcfg, impl="reference")
    joff = jradix.global_offsets(jhist)
    jbk, jbi = jbucketize.bucketize_tiles(jk, ji, shift, jcfg, impl=impl)
    jok, joi, joverflow = jscatter.scatter_runs(jbk, jbi, jhist, joff, jcfg,
                                                window_rows=cfg.tile_rows, impl=impl)
    assert not bool(joverflow)
    tables = (torch.from_numpy(np.asarray(t)[:, : cfg.radix].copy()) for t in (jhist, joff))
    return (*tables, jok, joi)


@pytest.mark.parametrize("bits", [1, 2, 4])
@pytest.mark.parametrize("tile_rows", [1, 8])
def test_bucketize_scatter_matches_jax(bits, tile_rows, rng):
    # The fused pass's plain version, the look-back pass's oracle, against
    # the JAX package's two kernels, their jnp references, at radix 2, 4 and
    # 16 and tiles of 128 and 1,024 keys, exactly.
    cfg = EngineConfig(radix_bits=bits, tile_rows=tile_rows)
    for shift in (0, 28):
        for name, keys in _keysets(rng, 3 * cfg.block).items():
            idx = rng.permutation(keys.size).astype(np.uint32)
            hist, offsets, jok, joi = _jax_fused_pass(keys, idx, shift, cfg, "reference")
            tk, ti = torch.from_numpy(keys.copy()), torch.from_numpy(idx.copy())
            _eq(tradix.tile_histograms(tk, shift, cfg), hist)
            tok, toi = tscatter._bucketize_scatter_ref(tk, ti, hist, offsets, shift, cfg)
            _eq(tok, jok)
            _eq(toi, joi)


def test_bucketize_scatter_matches_pallas_interpret(rng):
    # The Pallas bodies of both of the JAX package's kernels, at one small shape.
    cfg = EngineConfig(radix_bits=2)
    keys = rng.integers(0, 2**32, cfg.block, dtype=np.uint32)
    idx = rng.permutation(keys.size).astype(np.uint32)
    hist, offsets, jok, joi = _jax_fused_pass(keys, idx, 2, cfg, "interpret")
    tok, toi = tscatter._bucketize_scatter_ref(torch.from_numpy(keys), torch.from_numpy(idx),
                                               hist, offsets, 2, cfg)
    _eq(tok, jok)
    _eq(toi, joi)


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
@pytest.mark.parametrize("shift", SHIFTS)
def test_tile_destinations_match_jax(bits, shift, rng):
    cfg, jcfg = EngineConfig(radix_bits=bits), JaxConfig(radix_bits=bits)
    for name, keys in _keysets(rng, 2 * cfg.block).items():
        jk, _, tk, _ = _both(keys)
        joff = jradix.global_offsets(jradix.tile_histograms(jk, shift, jcfg, impl="reference"))
        jdest = jradix.tile_destinations(jk, joff, shift, jcfg, impl="reference")
        toff = tradix.global_offsets(tradix.tile_histograms(tk, shift, cfg))
        tdest = tradix.tile_destinations(tk, toff, shift, cfg)
        _eq(tdest, jdest)
        # A permutation that sorts the keys stably by the digit.
        digit = (keys >> np.uint32(shift)) & np.uint32(cfg.radix - 1)
        order = np.argsort(digit, kind="stable")
        np.testing.assert_array_equal(tdest.numpy()[order], np.arange(keys.size))


@pytest.mark.parametrize("tile_rows", [1, 3, 16])
def test_tile_destinations_other_tile_sizes(tile_rows, rng):
    cfg = EngineConfig(radix_bits=8, tile_rows=tile_rows)
    jcfg = JaxConfig(radix_bits=8, tile_rows=tile_rows)
    keys = rng.integers(0, 2**32, 2 * cfg.block, dtype=np.uint32)
    jk, _, tk, _ = _both(keys)
    joff = jradix.global_offsets(jradix.tile_histograms(jk, 4, jcfg, impl="reference"))
    toff = tradix.global_offsets(tradix.tile_histograms(tk, 4, cfg))
    _eq(tradix.tile_destinations(tk, toff, 4, cfg),
        jradix.tile_destinations(jk, joff, 4, jcfg, impl="reference"))


def _moved_columns(rng, n: int, count: int) -> list:
    """``count`` columns of n rows, cycling through the layouts a dest_scatter
    launch moves, in dtypes JAX keeps: 4-byte words, 2-D int32 rows of 4
    and 3 words, float32, 2- and 1-byte elements and rows."""
    makers = (
        lambda: rng.integers(0, 2**32, n, dtype=np.uint32),
        lambda: rng.integers(-(2**31), 2**31, (n, 4)).astype(np.int32),
        lambda: rng.standard_normal(n).astype(np.float32),
        lambda: rng.integers(-(2**31), 2**31, (n, 3)).astype(np.int32),
        lambda: rng.integers(-(2**15), 2**15, n).astype(np.int16),
        lambda: rng.integers(0, 2, n).astype(bool),
        lambda: rng.integers(0, 256, (n, 5)).astype(np.uint8),
        lambda: rng.integers(-(2**15), 2**15, (n, 3)).astype(np.int16),
        lambda: rng.standard_normal((n, 2)).astype(np.float32),
    )
    return [makers[i % len(makers)]() for i in range(count)]


def _jax_dest_scatter(keys, columns, shift, jcfg, impl="reference"):
    """The JAX package's radix pass moves: tile_destinations, then its scatter."""
    jk = jnp.asarray(keys).reshape(-1, LANES)
    joff = jradix.global_offsets(jradix.tile_histograms(jk, shift, jcfg, impl="reference"))
    jdest = jradix.tile_destinations(jk, joff, shift, jcfg, impl=impl)
    return jpermute.scatter_by_destination(
        jdest.reshape(-1), [jnp.asarray(c) for c in columns], strategy="xla_scatter")


@pytest.mark.parametrize("count", [0, 1, 9])
@pytest.mark.parametrize("tile_rows", [1, 3, 8])
@pytest.mark.parametrize("bits", [1, 2, 4, 8])
def test_dest_scatter_matches_jax(bits, tile_rows, count, rng):
    # 9 columns: more than one launch takes on the card.
    cfg = EngineConfig(radix_bits=bits, tile_rows=tile_rows)
    jcfg = JaxConfig(radix_bits=bits, tile_rows=tile_rows)
    keys = rng.integers(0, 2**32, 2 * cfg.block, dtype=np.uint32)
    columns = _moved_columns(rng, keys.size, count)
    want = _jax_dest_scatter(keys, columns, 4, jcfg)
    tk = torch.from_numpy(keys)
    hist = tradix.tile_histograms(tk, 4, cfg)
    got = tradix.dest_scatter(tk, hist, tradix.global_offsets(hist), 4, cfg,
                              [torch.from_numpy(c) for c in columns])
    assert len(got) == count
    for g, w in zip(got, want):
        _eq(g, w)


def test_dest_scatter_matches_pallas_interpret(rng):
    # The Pallas body of K4, then the JAX package's scatter, at one small shape.
    cfg, jcfg = EngineConfig(), JaxConfig()
    keys = rng.integers(0, 2**32, cfg.block, dtype=np.uint32)
    columns = _moved_columns(rng, keys.size, 2)
    want = _jax_dest_scatter(keys, columns, 0, jcfg, impl="interpret")
    tk = torch.from_numpy(keys)
    hist = tradix.tile_histograms(tk, 0, cfg)
    got = tradix.dest_scatter(tk, hist, tradix.global_offsets(hist), 0, cfg,
                              [torch.from_numpy(c) for c in columns])
    for g, w in zip(got, want):
        _eq(g, w)


def test_dest_scatter_rejects_bad_input():
    cfg = EngineConfig()
    keys = torch.zeros(cfg.block, dtype=torch.int32).view(torch.uint32)
    hist = tradix.tile_histograms(keys, 0, cfg)
    offsets = tradix.global_offsets(hist)
    col = torch.zeros(cfg.block, dtype=torch.int32)
    for call, match in (
        (lambda: tradix.dest_scatter(keys.view(torch.int32), hist, offsets, 0, cfg, [col]),
         "uint32"),
        (lambda: tradix.dest_scatter(keys, hist[:, :4].contiguous(), offsets, 0, cfg, [col]),
         "hist"),
        (lambda: tradix.dest_scatter(keys, hist, offsets.t().contiguous().t(), 0, cfg, [col]),
         "offsets"),
        (lambda: tradix.dest_scatter(keys, hist, offsets, 0, cfg, [col[1:]]), "rows"),
        (lambda: tradix.dest_scatter(keys, hist, offsets, 0, cfg,
                                     [torch.zeros((2, cfg.block), dtype=torch.int32).t()]),
         "contiguous"),
        (lambda: tradix.dest_scatter(keys, hist, offsets, 0, cfg, [col], impl="cuda"),
         "CUDA tensor"),
    ):
        with pytest.raises(ValueError, match=match):
            call()


@pytest.mark.parametrize("tile_rows", [1, 3, 8, 16, 64, 300, 302, 512])
def test_dest_scatter_geometry_fits_the_card(tile_rows):
    # What grs_radix_dest_scatter accepts: a partition of 1, 2, 4 or 8
    # tiles, one warp each, whose rows fit 16 bits; a block of one partition,
    # or of up to 4 partitions of one tile, its shared memory within 227 KB
    # (above 48 KB the entry point opts in).  The partition is the fewest tiles
    # whose digit runs reach DEST_SCATTER_RUN_ROWS rows, fewer where the
    # launch's partitions or the card's limits call for it; a tile whose
    # staging alone exceeds a block's shared memory is refused.
    for bits in range(1, 9):
        cfg = _geometry_cfg(1 << bits, tile_rows)
        one = -(-(8 * cfg.radix + 6 * cfg.tile) // 16) * 16
        assert tradix.dest_scatter_partition_bytes(cfg.radix, cfg.tile, 1) == one
        for num_tiles in (1, 7, 8, 9, 132, 984, 16_384, 97_664):
            if one > tradix.MAX_SHARED_BYTES:
                with pytest.raises(ValueError, match="stages a tile"):
                    tradix.dest_scatter_geometry(cfg, num_tiles)
                continue
            threads, per_block, shared = tradix.dest_scatter_geometry(cfg, num_tiles)
            assert per_block in (1, 2, 4, 8)
            assert per_block * cfg.tile <= tradix.MAX_PARTITION_ROWS
            part = tradix.dest_scatter_partition_bytes(cfg.radix, cfg.tile, per_block)
            partitions = threads // (32 * per_block)
            assert threads == 32 * per_block * partitions and 32 <= threads <= 256
            assert shared == partitions * part <= tradix.MAX_SHARED_BYTES and shared % 16 == 0
            assert partitions == (min(4, tradix.MAX_SHARED_BYTES // part) if per_block == 1
                                  else 1)
            runs_long = per_block * cfg.tile >= tradix.DEST_SCATTER_RUN_ROWS * cfg.radix
            if per_block > 1:  # no fewer tiles make the runs long enough
                assert (per_block // 2) * cfg.tile < tradix.DEST_SCATTER_RUN_ROWS * cfg.radix
                assert -(-num_tiles // per_block) >= tradix.DEST_SCATTER_MIN_BLOCKS
            if per_block < 8 and not runs_long:  # more tiles are refused by a limit
                twice = 2 * per_block
                assert (-(-num_tiles // twice) < tradix.DEST_SCATTER_MIN_BLOCKS
                        or twice * cfg.tile > tradix.MAX_PARTITION_ROWS
                        or tradix.dest_scatter_partition_bytes(cfg.radix, cfg.tile, twice)
                        > tradix.MAX_SHARED_BYTES)
    # The default tile at 1M, 2^24 and 100M keys.
    for bits, num_tiles, want in DEFAULT_DEST_SCATTER_GEOMETRY:
        assert tradix.dest_scatter_geometry(_geometry_cfg(1 << bits, 8), num_tiles) == want


# (radix bits, tiles, (threads, tiles a partition, shared bytes)) of the
# default 1,024-key tile at 1M (984 tiles), 2^24 and 100M keys.
DEFAULT_DEST_SCATTER_GEOMETRY = [
    (1, 984, (128, 1, 24640)), (1, 16_384, (128, 1, 24640)), (1, 97_664, (128, 1, 24640)),
    (4, 984, (128, 1, 25088)), (4, 16_384, (128, 1, 25088)), (4, 97_664, (128, 1, 25088)),
    (8, 984, (128, 4, 29696)), (8, 16_384, (256, 8, 58368)), (8, 97_664, (256, 8, 58368)),
    (6, 16_384, (64, 2, 13056)),
]


def _one_warp_design_took(radix: int, tile: int) -> bool:
    """Whether the earlier one-warp-a-tile dest_scatter took a tile: its warp's staging,
    2 x radix int32 above radix 32 and 6 bytes a key, within a block's shared memory."""
    return -(-((8 * radix if radix > 32 else 0) + 6 * tile) // 16) * 16 <= tradix.MAX_SHARED_BYTES


def test_dest_scatter_geometry_takes_every_tile_the_one_warp_design_took():
    # Every (radix, tile_rows) the one-warp-a-tile kernel took, tile_rows 1
    # to 300 at every radix, 301 up to radix 128 and 302 up to radix 64,
    # still gets a geometry, with one tile a partition where no more fit;
    # the rest are refused as before.
    for tile_rows in range(1, 401):
        for bits in range(1, 9):
            cfg = _geometry_cfg(1 << bits, tile_rows)
            took = _one_warp_design_took(cfg.radix, cfg.tile)
            assert took == (tile_rows <= 300 or (tile_rows == 301 and bits <= 7)
                            or (tile_rows == 302 and bits <= 6))
            for num_tiles in (1, 97_664):
                if took:
                    assert tradix.dest_scatter_geometry(cfg, num_tiles)[1] >= 1
                else:
                    with pytest.raises(ValueError, match="stages a tile"):
                        tradix.dest_scatter_geometry(cfg, num_tiles)


def _partition_order(keys, hist, offsets, shift: int, radix: int, tile: int, t0: int,
                     per_block: int):
    """A plain model of one dest_scatter partition, merged as ``csrc/radix_dest.cu`` merges it.

    The partition is tiles t0 .. t0 + per_block - 1 of the numpy buffer
    ``keys`` (fewer where the buffer ends).  Positions run digit-major, then
    tile-major, then in element order.  Returns (src, dst): for each
    position, the partition row it takes and its destination, from K1's
    rows of the partition (``hist``) and the offsets' first row only:
    ``offsets[t0, d] + p - start[d]``, start[d] the partition's start of
    digit d.
    """
    live = min(per_block, keys.size // tile - t0)
    h = hist[t0:t0 + live].astype(np.int64)
    earlier = np.cumsum(h, axis=0) - h  # each digit's count in the partition's earlier tiles
    totals = h.sum(axis=0)
    start = np.cumsum(totals) - totals
    digits = ((keys[t0 * tile:(t0 + live) * tile] >> np.uint32(shift))
              & np.uint32(radix - 1)).astype(np.int64)
    rows = np.arange(live * tile)
    rank = np.empty(rows.size, dtype=np.int64)  # earlier rows of the tile with the digit
    for t in range(live):
        d = digits[t * tile:(t + 1) * tile]
        order = np.argsort(d, kind="stable")
        rank[t * tile + order] = np.arange(tile) - np.searchsorted(d[order], d[order])
    pos = start[digits] + earlier[rows // tile, digits] + rank
    src = np.empty_like(rows)
    src[pos] = rows
    dst = np.empty_like(rows)
    dst[pos] = offsets[t0, digits].astype(np.int64) + pos - start[digits]
    return src, dst


def _jax_destinations(keys, shift: int, jcfg, impl: str = "reference") -> np.ndarray:
    """The JAX package's tile_destinations of ``keys``, padded with PAD_KEY to its grid
    step (pad keys take the last digit after every real key, so the real rows' destinations
    are those of the unpadded buffer)."""
    step = jcfg.tile * 8
    padded = np.concatenate([keys, np.full(-keys.size % step, 0xFFFFFFFF, dtype=np.uint32)])
    jk = jnp.asarray(padded).reshape(-1, LANES)
    joff = jradix.global_offsets(jradix.tile_histograms(jk, shift, jcfg, impl="reference"))
    return np.asarray(jradix.tile_destinations(jk, joff, shift, jcfg, impl=impl)).reshape(-1)[
        :keys.size]


def _check_partitions(keys, shift: int, cfg, per_block: int, want: np.ndarray) -> None:
    """Every partition of the model against ``want``, the destinations of every key."""
    tk = torch.from_numpy(keys)
    hist = tradix.tile_histograms(tk, shift, cfg)
    offsets = tradix.global_offsets(hist).numpy()
    hist = hist.numpy()
    np.testing.assert_array_equal(
        tradix.tile_destinations(tk, torch.from_numpy(offsets), shift, cfg).numpy(), want)
    num_tiles = keys.size // cfg.tile
    for t0 in range(0, num_tiles, per_block):
        src, dst = _partition_order(keys, hist, offsets, shift, cfg.radix, cfg.tile, t0,
                                    per_block)
        first = t0 * cfg.tile
        np.testing.assert_array_equal(dst, want[first + src])
        digits = (keys[first + src] >> np.uint32(shift)) & np.uint32(cfg.radix - 1)
        assert np.all(np.diff(digits.astype(np.int64)) >= 0)  # digit-major
        cut = np.flatnonzero(np.diff(digits.astype(np.int64))) + 1
        for s_run, d_run in zip(np.split(src, cut), np.split(dst, cut)):
            assert np.all(np.diff(s_run) > 0)  # stable: tile-major, then element order
            np.testing.assert_array_equal(d_run, d_run[0] + np.arange(d_run.size))  # one run


def _largest_partition(cfg) -> int:
    """The most tiles a dest_scatter partition of ``cfg`` can take, whatever the runs."""
    with mock.patch.multiple(tradix, DEST_SCATTER_RUN_ROWS=1 << 30, DEST_SCATTER_MIN_BLOCKS=1):
        return tradix.dest_scatter_tiles(cfg, 1)


@pytest.mark.parametrize("tile_rows", [1, 3, 8])
@pytest.mark.parametrize("bits", [1, 2, 4, 8])
def test_partition_order_matches_tile_destinations(bits, tile_rows, rng):
    # The kernel's merged order of a partition of P tiles against K4's
    # destinations (the port's plain version and the JAX package's
    # reference): P - 1, P, P + 1 and 3P + 1 tiles, so that the last
    # partition is ragged, whole, one tile, and one tile after whole ones.
    cfg = EngineConfig(radix_bits=bits, tile_rows=tile_rows)
    jcfg = JaxConfig(radix_bits=bits, tile_rows=tile_rows)
    per_block = _largest_partition(cfg)
    assert per_block == tradix.DEST_SCATTER_TILES_PER_BLOCK
    for num_tiles in (per_block - 1, per_block, per_block + 1, 3 * per_block + 1):
        keys = rng.integers(0, 2**32, num_tiles * cfg.tile, dtype=np.uint32)
        keys[: keys.size // 3] &= np.uint32(0xFF0F)  # a skewed stretch: long and empty runs
        want = _jax_destinations(keys, 4, jcfg)
        _check_partitions(keys, 4, cfg, per_block, want)


def test_partition_order_matches_pallas_interpret(rng):
    # The same against the Pallas body of K4, at one small shape: P + 1
    # tiles of 128 keys at radix 16.
    cfg, jcfg = EngineConfig(tile_rows=1), JaxConfig(tile_rows=1)
    per_block = _largest_partition(cfg)
    keys = rng.integers(0, 2**32, (per_block + 1) * cfg.tile, dtype=np.uint32)
    _check_partitions(keys, 0, cfg, per_block, _jax_destinations(keys, 0, jcfg, "interpret"))


@pytest.mark.parametrize("n", [1, 7, 128, 1023, 1025, 4096, 100_000,
                               tscan.CHUNK - 1, tscan.CHUNK, tscan.CHUNK + 1])
def test_exclusive_scan_matches_jax(n, rng):
    for x in (rng.integers(0, 5, n).astype(np.int32),
              rng.integers(-(2**31), 2**31 - 1, n).astype(np.int32)):  # wraps
        scan, total = jscan.exclusive_scan(jnp.asarray(x), impl="reference")
        tscan_, ttotal = tscan.exclusive_scan(torch.from_numpy(x))
        _eq(tscan_, scan)
        assert ttotal.dtype == torch.int32 and ttotal.dim() == 0
        assert int(ttotal) == int(total)


def test_exclusive_scan_near_the_int32_limit():
    x = torch.tensor([2**31 - 1, 1, 2**31 - 1, 5], dtype=torch.int32)
    scan, total = tscan.exclusive_scan(x)
    np.testing.assert_array_equal(scan.numpy(), [0, 2**31 - 1, -(2**31), -1])
    assert int(total) == 4
    empty, zero = tscan.exclusive_scan(torch.zeros(0, dtype=torch.int32))
    assert empty.numel() == 0 and int(zero) == 0


def test_destinations_and_scan_match_pallas_interpret(rng):
    # The Pallas bodies of K4 and K5 at one small shape each.
    cfg, jcfg = EngineConfig(), JaxConfig()
    keys = rng.integers(0, 2**32, cfg.block, dtype=np.uint32)
    jk, _, tk, _ = _both(keys)
    joff = jradix.global_offsets(jradix.tile_histograms(jk, 0, jcfg, impl="reference"))
    jdest = jradix.tile_destinations(jk, joff, 0, jcfg, impl="interpret")
    toff = tradix.global_offsets(tradix.tile_histograms(tk, 0, cfg))
    _eq(tradix.tile_destinations(tk, toff, 0, cfg), jdest)

    x = rng.integers(0, 7, 3 * cfg.tile).astype(np.int32)
    scan, total = jscan.exclusive_scan(jnp.asarray(x), jcfg, impl="interpret")
    tscan_, ttotal = tscan.exclusive_scan(torch.from_numpy(x))
    _eq(tscan_, scan)
    assert int(ttotal) == int(total)


def test_digits_of_matches_jax():
    keys = np.array([0, 1, 0xF0, 0xFFFFFFFF, 0x80000000, 0x12345678], dtype=np.uint32)
    for shift, radix in ((0, 16), (4, 16), (28, 16), (31, 2), (24, 256)):
        want = np.asarray(jradix._digits_of(jnp.asarray(keys), shift, radix))
        got = tradix.digits_of(torch.from_numpy(keys), shift, radix)
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_wrappers_reject_bad_input():
    cfg = EngineConfig()
    good = torch.zeros(cfg.block, dtype=torch.int32).view(torch.uint32)
    with pytest.raises(ValueError, match="uint32"):
        tradix.tile_histograms(torch.zeros(cfg.block, dtype=torch.int64), 0, cfg)
    with pytest.raises(ValueError, match="multiple of the tile"):
        tradix.tile_histograms(good[: cfg.tile - 1], 0, cfg)
    with pytest.raises(ValueError, match="1-D"):
        tradix.tile_histograms(good.view(-1, LANES), 0, cfg)
    with pytest.raises(ValueError, match="radix <= 16"):
        tbucketize.bucketize_tiles(good, good, 0, EngineConfig(radix_bits=8))
    with pytest.raises(ValueError, match="one length"):
        tbucketize.bucketize_tiles(good, good[: cfg.tile], 0, cfg)
    hist = tradix.tile_histograms(good, 0, cfg)
    with pytest.raises(ValueError, match="offsets"):
        tscatter.scatter_runs(good, good, hist, hist[:, :4].contiguous(), cfg)
    with pytest.raises(ValueError, match="offsets"):
        tradix.tile_destinations(good, hist[:, :4].contiguous(), 0, cfg)
    with pytest.raises(ValueError, match="1-D integer"):
        tscan.exclusive_scan(torch.zeros(4, dtype=torch.float32))
    with pytest.raises(ValueError, match="contiguous"):
        tscatter.scatter_runs(good, good, hist, hist.t().contiguous().t(), cfg)
    for call in (
        lambda: tradix.tile_histograms(good, 0, cfg, impl="cuda"),
        lambda: tbucketize.bucketize_tiles(good, good, 0, cfg, impl="cuda"),
        lambda: tscatter.scatter_runs(good, good, hist, hist, cfg, impl="cuda"),
        lambda: tradix.tile_destinations(good, hist, 0, cfg, impl="cuda"),
        lambda: tscan.exclusive_scan(hist.view(-1), impl="cuda"),
    ):
        with pytest.raises(ValueError, match="CUDA tensor"):
            call()


def _geometry_cfg(radix: int, tile_rows: int):
    # Any power-of-two radix, including the 8- to 128-bucket ones EngineConfig cannot name.
    return types.SimpleNamespace(radix=radix, tile=tile_rows * LANES, tile_rows=tile_rows)


@pytest.mark.parametrize("tile_rows", range(1, 17))
def test_launch_geometry_fits_the_card(tile_rows):
    # What grs_radix_hist and grs_bucketize accept: one warp per tile, at most
    # 8 tiles (256 threads) a block, shared memory within a block's 227 KB.
    for bits in range(1, 9):
        cfg = _geometry_cfg(1 << bits, tile_rows)
        threads, shared = tradix.hist_geometry(cfg)
        assert threads % 32 == 0 and 32 <= threads <= 256 <= 1024
        # radix > 16: an 8-bit field per (digit, lane) in each warp's table
        assert shared == (threads // 32 * 32 * cfg.radix if cfg.radix > 16 else 0)
        assert shared <= tradix.MAX_SHARED_BYTES == 232_448
        if cfg.radix > 16:
            continue
        threads, shared = tbucketize.bucketize_geometry(cfg)
        assert threads % 32 == 0 and 32 <= threads <= 256
        per_key = 16 if cfg.tile == tbucketize.FAST_TILE else 8  # input staged too
        assert shared == threads // 32 * per_key * cfg.tile <= tradix.MAX_SHARED_BYTES
        assert cfg.tile % 128 == 0


@pytest.mark.parametrize("tile_rows", range(1, 17))
def test_dest_geometry_fits_the_card(tile_rows):
    # What grs_radix_dest accepts: one warp per tile, at most 8 tiles (256
    # threads) a block; above radix 32 a warp-private table of radix int32.
    for bits in range(1, 9):
        cfg = _geometry_cfg(1 << bits, tile_rows)
        threads, shared = tradix.dest_geometry(cfg)
        assert threads % 32 == 0 and 32 <= threads <= 256
        assert shared == (threads // 32 * 4 * cfg.radix if cfg.radix > 32 else 0)
        assert shared <= 8 * 4 * 256 <= tradix.MAX_SHARED_BYTES
        assert cfg.tile % 128 == 0


@pytest.mark.parametrize("n, chunks", [(1, 1), (tscan.CHUNK - 1, 1), (tscan.CHUNK, 1),
                                       (tscan.CHUNK + 1, 2), (2 * tscan.CHUNK + 1, 3),
                                       (100_000_000, 12_208)])
def test_scan_scratch_words(n, chunks):
    # The chunk counter, then one status word a chunk the kernel scans.
    assert tscan.scratch_words(n) == chunks + 1


def test_bucketize_geometry_limits():
    # The largest tile whose two staged halves fit one block, then one past it.
    threads, shared = tbucketize.bucketize_geometry(_geometry_cfg(16, 227))
    assert (threads, shared) == (32, 227 * 128 * 8)
    tiles = tbucketize.BUCKETIZE_TILES_PER_BLOCK
    assert tbucketize.bucketize_geometry(_geometry_cfg(16, 8)) == (32 * tiles, tiles * 16384)
    assert tbucketize.bucketize_geometry(_geometry_cfg(16, 7)) == (32 * tiles, tiles * 7168)
    with pytest.raises(ValueError, match="tile_rows <= 227"):
        tbucketize.bucketize_geometry(_geometry_cfg(16, 228))


def test_plain_path_launches_no_kernel(rng):
    cfg = EngineConfig()
    wrappers = (tradix.tile_histograms, tbucketize.bucketize_tiles, tscatter.scatter_runs,
                tradix.tile_destinations, tscan.exclusive_scan, tradix.dest_scatter)
    before = [w.launches for w in wrappers]
    keys = torch.from_numpy(rng.integers(0, 2**32, cfg.block, dtype=np.uint32))
    hist = tradix.tile_histograms(keys, 0, cfg)
    offsets = tradix.global_offsets(hist)
    bk, bi = tbucketize.bucketize_tiles(keys, keys, 0, cfg)
    tscatter.scatter_runs(bk, bi, hist, offsets, cfg)
    tradix.tile_destinations(keys, offsets, 0, cfg)
    tradix.dest_scatter(keys, hist, offsets, 0, cfg, [keys, bk])
    assert [w.launches for w in wrappers] == before


@pytest.mark.parametrize("rows, refused", [(2**31, True), (2**31 + EngineConfig().block, True),
                                           (2**31 - EngineConfig().tile, True),
                                           (2**31 - EngineConfig().block, False)])
def test_check_keys_refuses_2_31_rows(rows, refused):
    # A meta tensor allocates nothing.  From 2^31 elements the kernels' int32
    # offsets and destinations would wrap, so every wrapper refuses the buffer;
    # K3 also needs a tile of headroom, so the limit is 2^31 less a block.
    cfg = EngineConfig()
    keys = torch.empty(rows, dtype=torch.uint32, device="meta")
    if not refused:
        assert tradix.check_keys("keys", keys, cfg) == rows // cfg.tile
        return
    tables = torch.empty((rows // cfg.tile, cfg.radix), dtype=torch.int32, device="meta")
    for call in (
        lambda: tradix.check_keys("keys", keys, cfg),
        lambda: tradix.tile_histograms(keys, 0, cfg),
        lambda: tbucketize.bucketize_tiles(keys, keys, 0, cfg),
        lambda: tscatter.scatter_runs(keys, keys, tables, tables, cfg),
        lambda: tradix.tile_destinations(keys, tables, 0, cfg),
        lambda: tradix.dest_scatter(keys, tables, tables, 0, cfg, [keys]),
    ):
        with pytest.raises(ValueError, match=r"2\^31.*int32"):
            call()


@pytest.mark.parametrize("shift_by", [-5, 7])
def test_scatter_runs_drops_destinations_outside_the_buffer(shift_by, rng):
    # An inconsistent hist/offsets pair: every destination moved by shift_by.
    # Those past either end are dropped, as the JAX package's mode="drop"
    # drops them; the rest land where they would, moved.
    cfg = EngineConfig()
    keys = torch.from_numpy(rng.integers(0, 2**32, 2 * cfg.block, dtype=np.uint32))
    idx = torch.from_numpy(np.arange(keys.numel(), dtype=np.uint32))
    hist = tradix.tile_histograms(keys, 4, cfg)
    offsets = tradix.global_offsets(hist)
    bk, bi = tbucketize.bucketize_tiles(keys, idx, 4, cfg)
    want = tscatter.scatter_runs(bk, bi, hist, offsets, cfg)[:2]
    got = tscatter.scatter_runs(bk, bi, hist, offsets + shift_by, cfg)[:2]
    n, k = keys.numel(), abs(shift_by)
    for g, w in zip(got, want):
        g, w = g.view(torch.int32), w.view(torch.int32)
        kept, lost = (g[k:], g[:k]) if shift_by > 0 else (g[: n - k], g[n - k:])
        assert torch.equal(kept, w[: n - k] if shift_by > 0 else w[k:])
        assert not lost.any()  # never written: the plain version's zeros


ROUTES = {"skipped": None, "from the input": (tsort_plan.INPUT, tsort_plan.RESULT),
          "from R": (tsort_plan.RESULT, tsort_plan.SCRATCH),
          "from S": (tsort_plan.SCRATCH, tsort_plan.RESULT)}


def test_planned_pass_rejects_a_bad_plan(rng):
    # check_plan's refusals, through the look-back pass that a plan routes:
    # a plan of the wrong dtype or with no entry for the pass, missing or
    # misshapen result and scratch buffers, and buffers that share memory.
    cfg = EngineConfig()
    keys = torch.from_numpy(rng.integers(0, 2**32, cfg.tile, dtype=np.uint32))
    idx = keys.clone()
    buffers = tuple((torch.empty_like(keys), torch.empty_like(keys)) for _ in range(2))
    state = tsort_plan.sort_plan(keys, cfg, torch.zeros(1, dtype=torch.int64))

    def planned(plan, pass_index=0, routed=buffers):
        return tscatter.bucketize_scatter_lookback(keys, idx, cfg, state._replace(plan=plan),
                                                   pass_index, routed)

    for plan, pass_index in ((state.plan.to(torch.int64), 0), (state.plan[:3], 5)):
        with pytest.raises(ValueError, match="plan must be"):
            planned(plan, pass_index)
    for routed in ((buffers[0], (None, None)), ((keys[:128], keys[:128]), buffers[1])):
        with pytest.raises(ValueError, match="result and scratch"):
            planned(state.plan, 0, routed)
    # A pass must not write the buffer it reads, nor R and S share memory.
    for overlapping in (((keys, buffers[0][1]), buffers[1]), (buffers[0], buffers[0]),
                        ((buffers[1][0], buffers[0][1]), buffers[1])):
        with pytest.raises(ValueError, match="overlap"):
            planned(state.plan, 0, overlapping)


def _plan_of(keys, cfg):
    """The pass plan and skipped passes of ``keys`` by the host's oracles."""
    mask = tsort_plan.pass_mask(keys, cfg)
    return tsort_plan.plan_of_mask(mask, cfg.num_passes), cfg.num_passes - bin(mask).count("1")


def _count_sets(rng, cfg):
    """Padded buffers of the digit-count tests: pad rows behind random keys, equal keys, zeros."""
    n = cfg.block + cfg.tile + 37  # a part-filled block: PAD_KEY rows behind the live keys
    sets = {"random with pad rows": rng.integers(0, 2**32, n, dtype=np.uint32),
            "equal": np.full(2 * cfg.block, 0xDEADBEEF, dtype=np.uint32),
            "zero": np.zeros(cfg.block, dtype=np.uint32),
            "one digit holding 99%": np.where(rng.random(n) < 0.99, np.uint32(0x5A5A5A5A),
                                              rng.integers(0, 2**32, n, dtype=np.uint32))}
    return {name: make_key_column(keys.astype(np.uint32), cfg, device="cpu").data.numpy()
            for name, keys in sets.items()}


@pytest.mark.parametrize("bits", [1, 2, 4])
@pytest.mark.parametrize("tile_rows", [1, 3, 8])
def test_digit_counts_and_bases_match_jax(bits, tile_rows, rng):
    # sort_plan's plain counts and bases against the JAX package's per-pass
    # sum of K1's tile histograms and its exclusive scan, exactly; its plan
    # and skipped passes as the host's oracles give them.
    cfg = EngineConfig(radix_bits=bits, tile_rows=tile_rows)
    jcfg = JaxConfig(radix_bits=bits, tile_rows=tile_rows)
    for name, keys in _count_sets(rng, cfg).items():
        jk = jnp.asarray(keys).reshape(-1, LANES)
        want = np.stack([
            np.asarray(jnp.sum(jradix.tile_histograms(jk, p * bits, jcfg, impl="reference"),
                               axis=0))[: cfg.radix] for p in range(cfg.num_passes)])
        skipped = torch.zeros(1, dtype=torch.int64)
        state = tsort_plan.sort_plan(torch.from_numpy(keys), cfg, skipped)
        _eq(state.counts, want.astype(np.int32))
        _eq(state.bases, (np.cumsum(want, axis=1) - want).astype(np.int32))
        assert _plan_of(torch.from_numpy(keys), cfg) == (state.plan.tolist(), int(skipped)), name
        assert state.lookback.numel() == tsort_plan.lookback_words(keys.size // cfg.tile, cfg)


def test_digit_counts_of_no_keys():
    # No key fills no bucket; the plan then copies the (empty) input.
    state = tsort_plan.sort_plan(torch.empty(0, dtype=torch.uint32), EngineConfig(),
                                torch.zeros(1, dtype=torch.int64))
    assert not state.counts.any() and not state.bases.any()
    assert state.counts.shape == (8, 16) and state.lookback.numel() == 8  # the tickets


@pytest.mark.parametrize("bits", [1, 2, 4])
@pytest.mark.parametrize("tile_rows", [1, 3, 8])
def test_lookback_offsets_match_jax_global_offsets(bits, tile_rows, rng):
    # In every pass, the look-back's plain offsets (the pass's digit base plus
    # the counts of earlier tiles) equal the JAX package's global_offsets of
    # its tile histograms, and the look-back pass equals its fused pass.
    cfg = EngineConfig(radix_bits=bits, tile_rows=tile_rows)
    jcfg = JaxConfig(radix_bits=bits, tile_rows=tile_rows)
    for name, keys in _count_sets(rng, cfg).items():
        tk = torch.from_numpy(keys.copy())
        state = tsort_plan.sort_plan(tk, cfg, torch.zeros(1, dtype=torch.int64))
        jk = jnp.asarray(keys).reshape(-1, LANES)
        for p in range(0, cfg.num_passes, max(1, cfg.num_passes // 4)):
            jhist = jradix.tile_histograms(jk, p * bits, jcfg, impl="reference")
            hist = torch.from_numpy(np.asarray(jhist)[:, : cfg.radix].copy())
            _eq(tscatter._lookback_offsets_ref(hist, state.bases[p]),
                np.asarray(jradix.global_offsets(jhist))[:, : cfg.radix])
        idx = rng.permutation(keys.size).astype(np.uint32)
        shift = (cfg.num_passes - 1) * bits
        _, _, jok, joi = _jax_fused_pass(keys, idx, shift, cfg, "reference")
        tok, toi = tscatter.bucketize_scatter_lookback(tk, torch.from_numpy(idx), cfg, state,
                                                       cfg.num_passes - 1)
        _eq(tok, jok)
        _eq(toi, joi)


def test_lookback_pass_matches_pallas_interpret(rng):
    # The Pallas bodies of the JAX package's pass at one small shape.
    cfg = EngineConfig(radix_bits=2)
    keys = rng.integers(0, 2**32, cfg.block, dtype=np.uint32)
    idx = rng.permutation(keys.size).astype(np.uint32)
    _, _, jok, joi = _jax_fused_pass(keys, idx, 2, cfg, "interpret")
    state = tsort_plan.sort_plan(torch.from_numpy(keys), cfg, torch.zeros(1, dtype=torch.int64))
    tok, toi = tscatter.bucketize_scatter_lookback(torch.from_numpy(keys), torch.from_numpy(idx),
                                                   cfg, state, 1)
    _eq(tok, jok)
    _eq(toi, joi)


@pytest.mark.parametrize("num_tiles, bits, words", [(0, 4, 8), (1, 4, 40), (16, 4, 136),
                                                    (33, 4, 296), (16, 2, 48), (16, 1, 48),
                                                    (97_657, 4, 781_288)])
def test_lookback_scratch_words(num_tiles, bits, words):
    # Two int32 words (a 64-bit status word) a (partition of 4,096 keys,
    # digit), which every pass reuses, then a ticket a pass; sort_plan's
    # allocation keeps the counts, the lines the key read sums them in and
    # that scratch 8-byte aligned and last, where its memset clears them.
    cfg = EngineConfig(radix_bits=bits)
    assert tsort_plan.lookback_words(num_tiles, cfg) == words
    at = tsort_plan.state_layout(num_tiles, cfg)
    table = cfg.num_passes * cfg.radix
    assert (at["words"], at["plan"]) == (slice(0, 2), slice(2, 2 + cfg.num_passes))
    assert at["bases"] == slice(at["plan"].stop, at["plan"].stop + table)  # beside the plan
    assert at["counts"].start % 2 == 0 and at["counts"].start - at["bases"].stop in (0, 1)
    assert at["counts"].stop - at["counts"].start == table
    assert at["lines"] == slice(at["counts"].stop, at["counts"].stop + tsort_plan.COUNT_LINES)
    assert at["lookback"] == slice(at["lines"].stop, at["total"])
    assert at["lookback"].start % 2 == 0 and at["total"] - at["lookback"].start == words


@pytest.mark.parametrize("tile_rows", [1, 3, 8])
@pytest.mark.parametrize("num_tiles", [1, 29, 8_485])
def test_lookback_partitions_at_ragged_lengths(tile_rows, num_tiles):
    # A look-back block takes 4,096 keys whatever the tile: the last
    # partition holds the rest, and the scratch has a status word a
    # (partition, digit) and a ticket a pass.
    cfg = EngineConfig(tile_rows=tile_rows)
    padded = num_tiles * cfg.tile
    parts = tsort_plan.lookback_partitions(padded)
    size = tsort_plan.LOOKBACK_PARTITION
    assert (parts - 1) * size < padded <= parts * size
    assert tsort_plan.lookback_words(num_tiles, cfg) == 2 * parts * cfg.radix + cfg.num_passes
    if num_tiles < 100:  # sort_plan allocates it so
        state = tsort_plan.sort_plan(torch.zeros(padded, dtype=torch.uint32), cfg,
                                    torch.zeros(1, dtype=torch.int64))
        assert state.lookback.numel() == 2 * parts * cfg.radix + cfg.num_passes


def test_lookback_partition_is_the_kernels():
    # The scratch is sized on the host for the kernel's partition
    # (kPartThreads x kPartItems keys); the entry point refuses a shorter one.
    src = (pathlib.Path(tscatter.__file__).parents[1] / "csrc" / "bucketize_scatter.cu").read_text()
    consts = {name: int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
              for name in ("kPartThreads", "kPartItems")}
    assert consts["kPartThreads"] * consts["kPartItems"] == tsort_plan.LOOKBACK_PARTITION


def test_sort_plan_and_lookback_plain_launch_nothing(rng):
    cfg = EngineConfig()
    wrappers = (tsort_plan.sort_plan, tscatter.bucketize_scatter_lookback)
    before = [w.launches for w in wrappers]
    keys = torch.from_numpy(rng.integers(0, 2**32, cfg.block, dtype=np.uint32))
    state = tsort_plan.sort_plan(keys, cfg, torch.zeros(1, dtype=torch.int64))
    tscatter.bucketize_scatter_lookback(keys, keys, cfg, state, 0)
    assert [w.launches for w in wrappers] == before


@pytest.mark.parametrize("route", ROUTES)
def test_lookback_pass_reads_and_writes_the_named_buffers(route, rng):
    # Pass 1 of a plan routes the look-back pass: skipped, or from the
    # sort's input, its result R or its scratch S into another buffer.  It
    # writes the named destination as its unplanned call on the named
    # source would, and no other buffer.
    cfg = EngineConfig()
    n = 2 * cfg.tile

    def pair():
        return (torch.from_numpy(rng.integers(0, 2**32, n, dtype=np.uint32)),
                torch.from_numpy(rng.permutation(n).astype(np.uint32)))

    sources = (pair(), pair(), pair())  # the input, R, S
    before = [tuple(t.clone() for t in p) for p in sources]
    entry = tsort_plan.PLAN_SKIP if ROUTES[route] is None else tsort_plan.plan_entry(*ROUTES[route])
    state = tsort_plan.sort_plan(sources[0][0], cfg, torch.zeros(1, dtype=torch.int64))
    state = state._replace(plan=torch.tensor(
        [tsort_plan.plan_entry(tsort_plan.INPUT, tsort_plan.RESULT), entry] + [-1] * 6, dtype=torch.int32))
    assert tscatter.bucketize_scatter_lookback(*sources[0], cfg, state, 1,
                                               buffers=sources[1:]) is None
    written = None
    if ROUTES[route] is not None:
        src, written = ROUTES[route]
        want = tscatter.bucketize_scatter_lookback(*before[src], cfg, state, 1)
        assert all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                   for a, b in zip(sources[written], want))
    for i, (now, then) in enumerate(zip(sources, before)):
        if i != written:
            assert all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                       for a, b in zip(now, then)), (route, i)


def test_sort_plan_and_lookback_reject_bad_input(rng):
    cfg = EngineConfig()
    keys = torch.from_numpy(rng.integers(0, 2**32, cfg.block, dtype=np.uint32))
    skipped = torch.zeros(1, dtype=torch.int64)
    with pytest.raises(ValueError, match="1, 2 or 4 bits"):
        tsort_plan.sort_plan(keys, EngineConfig(radix_bits=8), skipped)
    with pytest.raises(ValueError, match="multiple of the tile"):
        tsort_plan.sort_plan(keys[:100], cfg, skipped)
    with pytest.raises(ValueError, match="skipped"):
        tsort_plan.sort_plan(keys, cfg, skipped.to(torch.int32))
    with pytest.raises(ValueError, match="CUDA tensor"):
        tsort_plan.sort_plan(keys, cfg, skipped, impl="cuda")
    state = tsort_plan.sort_plan(keys, cfg, skipped)
    for bad, match in ((dict(pass_index=8), "pass_index"),
                       (dict(state=state._replace(lookback=state.lookback[:-1])), "sort_plan"),
                       (dict(state=state._replace(bases=state.bases[:4])), "sort_plan")):
        kwargs = {"state": state, "pass_index": 0, **bad}
        with pytest.raises(ValueError, match=match):
            tscatter.bucketize_scatter_lookback(keys, keys, cfg, **kwargs)
    with pytest.raises(ValueError, match="radix <= 16"):
        tscatter.bucketize_scatter_lookback(keys, keys, EngineConfig(radix_bits=8), state, 0)
    with pytest.raises(ValueError, match="one length"):
        tscatter.bucketize_scatter_lookback(keys, keys[: cfg.tile], cfg, state, 0)
    with pytest.raises(ValueError, match="overlap"):
        tscatter.bucketize_scatter_lookback(keys, keys.clone(), cfg, state, 0,
                                            buffers=((keys, keys.clone()), (keys.clone(),) * 2))
    with pytest.raises(ValueError, match="CUDA tensor"):
        tscatter.bucketize_scatter_lookback(keys, keys, cfg, state, 0, impl="cuda")


@pytest.mark.parametrize("rows", [2**31, 2**31 - EngineConfig().tile])
def test_sort_plan_and_lookback_refuse_2_31_rows(rows):
    # Meta tensors allocate nothing: from 2^31 less a block of rows the
    # counts and the offsets would wrap, so both wrappers refuse the buffer.
    cfg = EngineConfig()
    keys = torch.empty(rows, dtype=torch.uint32, device="meta")
    with pytest.raises(ValueError, match=r"2\^31.*int32"):
        tsort_plan.sort_plan(keys, cfg, torch.zeros(1, dtype=torch.int64, device="meta"))
    state = tsort_plan.SortPlan(*(torch.empty(0, dtype=torch.int32, device="meta"),) * 4)
    with pytest.raises(ValueError, match=r"2\^31.*int32"):
        tscatter.bucketize_scatter_lookback(keys, keys, cfg, state, 0)


# Live lengths of a two-block buffer: none, one, a tile less one, a multiple
# of the tile, one past it, and all of it.
def _live_lengths(cfg):
    return [0, 1, cfg.tile - 1, 3 * cfg.tile, 3 * cfg.tile + 1, 2 * cfg.block]


def _stale(cfg, length, gen):
    """A two-block buffer whose rows past ``length`` hold stale keys, and it re-padded."""
    buf = gen.integers(0, 2**32, 2 * cfg.block, dtype=np.uint32)
    buf[gen.random(buf.size) < 0.1] = np.uint32(0xFFFFFFFF)  # live keys equal to PAD_KEY
    repadded = buf.copy()
    repadded[length:] = 0xFFFFFFFF
    return buf, repadded


def _numpy_counts(keys: np.ndarray, cfg) -> np.ndarray:
    return np.stack([np.bincount((keys >> np.uint32(p * cfg.radix_bits)) & np.uint32(cfg.radix - 1),
                                 minlength=cfg.radix) for p in range(cfg.num_passes)])


@pytest.mark.parametrize("bits", [1, 2, 4])
def test_sort_plan_counts_the_live_keys_and_the_pads(bits):
    # sort_plan with a live length counts the live keys and the rows past
    # it, the pads, in no digit, whatever they hold: its counts are numpy's
    # of the live keys, its bases their exclusive prefix (which the pads,
    # all in the last digit, would not move), its plan and skipped passes
    # the live keys'.
    cfg = EngineConfig(radix_bits=bits)
    for length in _live_lengths(cfg):
        buf, repadded = _stale(cfg, length, np.random.default_rng([bits, length]))
        skipped = torch.zeros(1, dtype=torch.int64)
        state = tsort_plan.sort_plan(torch.from_numpy(buf), cfg, skipped, length=length)
        want = _numpy_counts(buf[:length], cfg)
        _eq(state.counts, want.astype(np.int32))
        _eq(state.bases, (np.cumsum(want, axis=1) - want).astype(np.int32))
        padded = _numpy_counts(repadded, cfg)
        _eq(state.bases, (np.cumsum(padded, axis=1) - padded).astype(np.int32))
        want_plan = _plan_of(torch.from_numpy(buf[:length].copy()), cfg)
        assert want_plan == (state.plan.tolist(), int(skipped)), length


@pytest.mark.parametrize("bits", [1, 2, 4])
def test_lookback_pass_reads_pads_and_makes_the_index(bits):
    # The look-back pass from the input with a live length and no index:
    # the JAX package's fused pass of the re-padded buffer and its
    # arange-then-PAD_INDEX index, in the first and the last pass; with the
    # index given, the rows past the length still read as pads.
    cfg = EngineConfig(radix_bits=bits)
    for length in _live_lengths(cfg):
        buf, repadded = _stale(cfg, length, np.random.default_rng([bits, length, 1]))
        idx = np.where(np.arange(buf.size) < length, np.arange(buf.size),
                       0xFFFFFFFF).astype(np.uint32)
        state = tsort_plan.sort_plan(torch.from_numpy(buf), cfg,
                                    torch.zeros(1, dtype=torch.int64), length=length)
        for p in (0, cfg.num_passes - 1):
            _, _, jok, joi = _jax_fused_pass(repadded, idx, p * bits, cfg, "reference")
            for given in (None, torch.from_numpy(buf[::-1].copy())):  # stale index rows too
                if given is not None:
                    given[:length] = torch.from_numpy(idx[:length])
                tok, toi = tscatter.bucketize_scatter_lookback(
                    torch.from_numpy(buf), given, cfg, state, p, length=length)
                _eq(tok, jok)
                _eq(toi, joi)


def test_lookback_pass_at_a_live_length_routes_as_planned():
    # A planned pass with a live length writes the named buffer as its
    # unplanned call does; passes from R or S read their rows past the
    # length as pads too.
    cfg = EngineConfig()
    gen = np.random.default_rng(7)
    keys = torch.from_numpy(gen.integers(0, 2**32, 2 * cfg.tile, dtype=np.uint32))
    pairs = [tuple(torch.from_numpy(gen.integers(0, 2**32, 2 * cfg.tile, dtype=np.uint32))
                   for _ in range(2)) for _ in range(2)]
    state = tsort_plan.sort_plan(keys, cfg, torch.zeros(1, dtype=torch.int64), length=100)
    for source, destination in ((tsort_plan.INPUT, tsort_plan.SCRATCH), (tsort_plan.SCRATCH, tsort_plan.RESULT)):
        plan = torch.tensor([tsort_plan.plan_entry(source, destination)] + [-1] * 7, dtype=torch.int32)
        routed = state._replace(plan=plan, lookback=torch.zeros_like(state.lookback))
        before = [tuple(t.clone() for t in pair) for pair in pairs]
        tscatter.bucketize_scatter_lookback(keys, None, cfg, routed, 0, tuple(pairs), length=100)
        src = (keys, None) if source == tsort_plan.INPUT else before[1]
        want = tscatter.bucketize_scatter_lookback(*src, cfg, routed, 0, length=100)
        assert all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                   for a, b in zip(pairs[destination - 1], want)), (source, destination)


@pytest.mark.parametrize("length", [0, 1, 4095, 4096, 4097, 4 * 4096 - 1])
def test_lookback_passes_write_pads_only_in_the_last(length):
    # The plain passes write what the card's do: a pass that a later one
    # follows writes its destination's live rows and no row past them; the
    # last that runs also writes every row of R from the length on as a
    # pad.  Rows past the length of R and S read as pads whatever they
    # hold.  The passes walk the live partitions, the length rounded up to
    # 4,096 rows.
    cfg = EngineConfig()
    n = 4 * tsort_plan.LOOKBACK_PARTITION
    assert tsort_plan.lookback_rows(length, n) == min(n, -(-length // 4096) * 4096)
    gen = np.random.default_rng(length)
    # Digits 0 and 2 vary, so the two passes below sort the keys.
    keys = torch.from_numpy(gen.integers(0, 2**32, n, dtype=np.uint32) & np.uint32(0xF0F))
    sentinel = 0x5EED5EED
    pairs = tuple(tuple(torch.full((n,), sentinel, dtype=torch.int32).view(torch.uint32)
                        for _ in range(2)) for _ in range(2))
    state = tsort_plan.sort_plan(keys, cfg, torch.zeros(1, dtype=torch.int64), length=length)
    e = tsort_plan.plan_entry
    plan = [e(tsort_plan.INPUT, tsort_plan.SCRATCH), -1, e(tsort_plan.SCRATCH, tsort_plan.RESULT)] + [-1] * 5
    state = state._replace(plan=torch.tensor(plan, dtype=torch.int32))
    (rk, ri), (sk, si) = pairs
    tscatter.bucketize_scatter_lookback(keys, None, cfg, state, 0, pairs, length=length)
    for t in (sk, si):
        assert (int32_bits(t[length:]) == sentinel).all()
    assert (int32_bits(rk) == sentinel).all() and (int32_bits(ri) == sentinel).all()
    int32_bits(sk)[length:] = 0  # stale: read as pads
    tscatter.bucketize_scatter_lookback(keys, None, cfg, state, 2, pairs, length=length)
    live_keys, live_idx = tsort_plan.live_input(keys, None, length)
    order = torch.sort(int32_bits(live_keys).to(torch.int64) & 0xFFFFFFFF, stable=True).indices
    assert torch.equal(int32_bits(rk), int32_bits(live_keys)[order])
    assert torch.equal(int32_bits(ri), int32_bits(live_idx)[order])


def test_sort_args_plain_words():
    # The argument block's plain version: the input's, the index's and R's
    # addresses (0 for none) and the live length, as int64 on the keys' device.
    keys = torch.zeros(EngineConfig().block, dtype=torch.int32).view(torch.uint32)
    result = (torch.empty_like(keys), torch.empty_like(keys))
    for idx, length in ((None, 5), (keys.clone(), keys.numel()), (None, 0)):
        block = tsort_plan.sort_args(tsort_plan.SortArgs(keys, idx, result, length))
        assert block.dtype == torch.int64 and block.shape == (tsort_plan.ARGS_WORDS,)
        assert block.tolist() == [keys.data_ptr(), 0 if idx is None else idx.data_ptr(),
                                  result[0].data_ptr(), result[1].data_ptr(), length]
    assert tsort_plan.sort_args(tsort_plan.SortArgs(keys, None, (None, None), 3))[2:4].tolist() \
        == [0, 0]


def test_sort_args_and_live_lengths_reject_bad_input():
    cfg = EngineConfig()
    keys = torch.zeros(cfg.block, dtype=torch.int32).view(torch.uint32)
    result = (torch.empty_like(keys), torch.empty_like(keys))
    for length in (-1, cfg.block + 1):
        with pytest.raises(ValueError, match="length"):
            tsort_plan.sort_args(tsort_plan.SortArgs(keys, None, result, length))
        with pytest.raises(ValueError, match="length"):
            tsort_plan.sort_plan(keys, cfg, torch.zeros(1, dtype=torch.int64), length=length)
    with pytest.raises(ValueError, match="index and result"):
        tsort_plan.sort_args(tsort_plan.SortArgs(keys, keys[:128], result, 1))
    with pytest.raises(ValueError, match="index and result"):
        tsort_plan.sort_args(tsort_plan.SortArgs(keys, None, (keys.view(torch.int32), keys), 1))
    with pytest.raises(ValueError, match="CUDA tensor"):
        tsort_plan.sort_args(tsort_plan.SortArgs(keys, None, result, 1), impl="cuda")
    with pytest.raises(ValueError, match="sort_args block"):
        tsort_plan.check_block(torch.zeros(4, dtype=torch.int64), keys)
    state = tsort_plan.sort_plan(keys, cfg, torch.zeros(1, dtype=torch.int64))
    with pytest.raises(ValueError, match="length"):
        tscatter.bucketize_scatter_lookback(keys, None, cfg, state, 0, length=cfg.block + 1)
    block = tsort_plan.sort_args(tsort_plan.SortArgs(keys, None, result, 1))
    with pytest.raises(ValueError, match="buffers"):  # the block's R would go unreturned
        tscatter.bucketize_scatter_lookback(keys, None, cfg, state, 0, length=1, block=block)


def test_sort_args_plain_launches_nothing():
    keys = torch.zeros(EngineConfig().block, dtype=torch.int32).view(torch.uint32)
    before = tsort_plan.sort_args.launches
    tsort_plan.sort_args(tsort_plan.SortArgs(keys, None, (None, None), 1))
    assert tsort_plan.sort_args.launches == before
