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

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpuradixsort_tpu.config import EngineConfig as JaxConfig
from gpuradixsort_tpu.kernels import bucketize as jbucketize
from gpuradixsort_tpu.kernels import radix as jradix
from gpuradixsort_tpu.kernels import scan as jscan
from gpuradixsort_tpu.kernels import scatter as jscatter
from gpuradixsort_tpu_torch.config import LANES, EngineConfig
from gpuradixsort_tpu_torch.core.table import make_key_column
from gpuradixsort_tpu_torch.kernels import bucketize as tbucketize
from gpuradixsort_tpu_torch.kernels import key_bits as tkey_bits
from gpuradixsort_tpu_torch.kernels import radix as tradix
from gpuradixsort_tpu_torch.kernels import scan as tscan
from gpuradixsort_tpu_torch.kernels import scatter as tscatter

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
    # The fused pass's plain version against the JAX package's two kernels,
    # their jnp references, at radix 2, 4 and 16 and tiles of 128 and 1,024
    # keys, exactly.
    cfg = EngineConfig(radix_bits=bits, tile_rows=tile_rows)
    for shift in (0, 28):
        for name, keys in _keysets(rng, 3 * cfg.block).items():
            idx = rng.permutation(keys.size).astype(np.uint32)
            hist, offsets, jok, joi = _jax_fused_pass(keys, idx, shift, cfg, "reference")
            tk, ti = torch.from_numpy(keys.copy()), torch.from_numpy(idx.copy())
            _eq(tradix.tile_histograms(tk, shift, cfg), hist)
            tok, toi = tscatter.bucketize_scatter(tk, ti, hist, offsets, shift, cfg)
            _eq(tok, jok)
            _eq(toi, joi)


def test_bucketize_scatter_matches_pallas_interpret(rng):
    # The Pallas bodies of both of the JAX package's kernels, at one small shape.
    cfg = EngineConfig(radix_bits=2)
    keys = rng.integers(0, 2**32, cfg.block, dtype=np.uint32)
    idx = rng.permutation(keys.size).astype(np.uint32)
    hist, offsets, jok, joi = _jax_fused_pass(keys, idx, 2, cfg, "interpret")
    tok, toi = tscatter.bucketize_scatter(torch.from_numpy(keys), torch.from_numpy(idx), hist,
                                          offsets, 2, cfg)
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
                tscatter.bucketize_scatter, tradix.tile_destinations, tscan.exclusive_scan)
    before = [w.launches for w in wrappers]
    keys = torch.from_numpy(rng.integers(0, 2**32, cfg.block, dtype=np.uint32))
    hist = tradix.tile_histograms(keys, 0, cfg)
    offsets = tradix.global_offsets(hist)
    bk, bi = tbucketize.bucketize_tiles(keys, keys, 0, cfg)
    tscatter.scatter_runs(bk, bi, hist, offsets, cfg)
    tscatter.bucketize_scatter(keys, keys, hist, offsets, 0, cfg)
    tradix.tile_destinations(keys, offsets, 0, cfg)
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
        lambda: tscatter.bucketize_scatter(keys, keys, tables, tables, 0, cfg),
        lambda: tradix.tile_destinations(keys, tables, 0, cfg),
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


ROUTES = {"skipped": None, "from the input": (tradix.INPUT, tradix.RESULT),
          "from R": (tradix.RESULT, tradix.SCRATCH), "from S": (tradix.SCRATCH, tradix.RESULT)}


@pytest.mark.parametrize("route", ROUTES)
def test_planned_pass_reads_and_writes_the_named_buffers(route, rng):
    # Pass 1 of a plan routes K1 and the fused pass: skipped, or from the
    # sort's input, its result R or its scratch S into another buffer.  K1
    # counts the named keys; the fused pass writes the named destination as
    # its unplanned call on the named source would, and no other buffer.
    cfg = EngineConfig()
    n = 2 * cfg.tile

    def pair():
        return (torch.from_numpy(rng.integers(0, 2**32, n, dtype=np.uint32)),
                torch.from_numpy(rng.permutation(n).astype(np.uint32)))

    sources = (pair(), pair(), pair())  # the input, R, S
    before = [tuple(t.clone() for t in p) for p in sources]
    entry = tradix.PLAN_SKIP if ROUTES[route] is None else tradix.plan_entry(*ROUTES[route])
    plan = torch.tensor([tradix.plan_entry(tradix.INPUT, tradix.RESULT), entry, -1],
                        dtype=torch.int32)
    routed = dict(plan=plan, pass_index=1, buffers=sources[1:])
    keys, idx = sources[0]
    hist = tradix.tile_histograms(keys, 4, cfg, **routed)
    offsets = tradix.global_offsets(hist)
    assert tscatter.bucketize_scatter(keys, idx, hist, offsets, 4, cfg, **routed) is None
    written = None
    if ROUTES[route] is not None:
        src, written = ROUTES[route]
        want_hist = tradix.tile_histograms(before[src][0], 4, cfg)
        assert torch.equal(hist, want_hist)
        want = tscatter.bucketize_scatter(*before[src], want_hist,
                                          tradix.global_offsets(want_hist), 4, cfg)
        assert all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                   for a, b in zip(sources[written], want))
    else:
        assert not hist.any()
    for i, (now, then) in enumerate(zip(sources, before)):
        if i != written:  # every other buffer, the source included, is unwritten
            assert all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                       for a, b in zip(now, then)), (route, i)


def test_planned_pass_rejects_a_bad_plan(rng):
    cfg = EngineConfig()
    keys = torch.from_numpy(rng.integers(0, 2**32, cfg.tile, dtype=np.uint32))
    buffers = tuple((torch.empty_like(keys), torch.empty_like(keys)) for _ in range(2))
    plan = torch.zeros(8, dtype=torch.int32)
    for bad in (dict(plan=plan.to(torch.int64), buffers=buffers),
                dict(plan=plan, pass_index=8, buffers=buffers), dict(plan=plan),
                dict(plan=plan, buffers=((keys[:128], keys[:128]), buffers[1]))):
        with pytest.raises(ValueError):
            tradix.tile_histograms(keys, 0, cfg, **bad)
    hist = tradix.tile_histograms(keys, 0, cfg)
    for bad in (dict(plan=plan), dict(plan=plan, buffers=(buffers[0], (None, None)))):
        with pytest.raises(ValueError, match="result and scratch"):
            tscatter.bucketize_scatter(keys, keys.clone(), hist, hist, 0, cfg, **bad)
    # A pass must not write the buffer it reads, nor R and S share memory.
    for overlapping in (((keys, buffers[0][1]), buffers[1]), (buffers[0], buffers[0]),
                        ((buffers[1][0], buffers[0][1]), buffers[1])):
        with pytest.raises(ValueError, match="overlap"):
            tscatter.bucketize_scatter(keys, keys.clone(), hist, hist, 0, cfg, plan=plan,
                                       buffers=overlapping)
    with pytest.raises(ValueError, match="overlap"):
        tradix.tile_histograms(keys, 0, cfg, plan=plan, buffers=((keys, keys), buffers[1]))


def test_bucketize_scatter_rejects_bad_input():
    cfg = EngineConfig()
    good = torch.zeros(cfg.block, dtype=torch.int32).view(torch.uint32)
    hist = tradix.tile_histograms(good, 0, cfg)
    with pytest.raises(ValueError, match="radix <= 16"):
        tscatter.bucketize_scatter(good, good, hist, hist, 0, EngineConfig(radix_bits=8))
    with pytest.raises(ValueError, match="one length"):
        tscatter.bucketize_scatter(good, good[: cfg.tile], hist, hist, 0, cfg)
    with pytest.raises(ValueError, match="offsets"):
        tscatter.bucketize_scatter(good, good, hist, hist[:, :4].contiguous(), 0, cfg)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tscatter.bucketize_scatter(good, good, hist, hist, 0, cfg, impl="cuda")


@pytest.mark.parametrize("tile_rows", [1, 3, 8, 16, 226])
def test_bucketize_scatter_geometry_fits_the_card(tile_rows):
    # What grs_bucketize_scatter accepts: one warp a tile, at most 8 a block,
    # 8 bytes a key of staging and, off the 1,024-key tile, 128 bytes of rows.
    cfg = _geometry_cfg(16, tile_rows)
    threads, shared = tscatter.bucketize_scatter_geometry(cfg)
    tiles = threads // 32
    assert 1 <= tiles <= tscatter.FUSED_TILES_PER_BLOCK
    assert shared == tiles * (8 * cfg.tile + (0 if cfg.tile == 1024 else 128))
    assert shared <= tradix.MAX_SHARED_BYTES
    if tile_rows <= 28:
        assert tiles == tscatter.FUSED_TILES_PER_BLOCK
    with pytest.raises(ValueError, match="tile_rows <= 226"):
        tscatter.bucketize_scatter_geometry(_geometry_cfg(16, 227))


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
    # and skipped passes as pass_plan's.
    cfg = EngineConfig(radix_bits=bits, tile_rows=tile_rows)
    jcfg = JaxConfig(radix_bits=bits, tile_rows=tile_rows)
    for name, keys in _count_sets(rng, cfg).items():
        jk = jnp.asarray(keys).reshape(-1, LANES)
        want = np.stack([
            np.asarray(jnp.sum(jradix.tile_histograms(jk, p * bits, jcfg, impl="reference"),
                               axis=0))[: cfg.radix] for p in range(cfg.num_passes)])
        skipped = [torch.zeros(1, dtype=torch.int64) for _ in range(2)]
        state = tkey_bits.sort_plan(torch.from_numpy(keys), cfg, skipped[0])
        _eq(state.counts, want.astype(np.int32))
        _eq(state.bases, (np.cumsum(want, axis=1) - want).astype(np.int32))
        assert torch.equal(state.plan,
                           tkey_bits.pass_plan(torch.from_numpy(keys), cfg, skipped[1])), name
        assert torch.equal(*skipped), name
        assert state.lookback.numel() == tkey_bits.lookback_words(keys.size // cfg.tile, cfg)


def test_digit_counts_of_no_keys():
    # No key fills no bucket; the plan then copies the (empty) input.
    state = tkey_bits.sort_plan(torch.empty(0, dtype=torch.uint32), EngineConfig(),
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
        state = tkey_bits.sort_plan(tk, cfg, torch.zeros(1, dtype=torch.int64))
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
    state = tkey_bits.sort_plan(torch.from_numpy(keys), cfg, torch.zeros(1, dtype=torch.int64))
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
    assert tkey_bits.lookback_words(num_tiles, cfg) == words
    at = tkey_bits.state_layout(num_tiles, cfg)
    table = cfg.num_passes * cfg.radix
    assert (at["words"], at["plan"]) == (slice(0, 2), slice(2, 2 + cfg.num_passes))
    assert at["bases"] == slice(at["plan"].stop, at["plan"].stop + table)  # beside the plan
    assert at["counts"].start % 2 == 0 and at["counts"].start - at["bases"].stop in (0, 1)
    assert at["counts"].stop - at["counts"].start == table
    assert at["lines"] == slice(at["counts"].stop, at["counts"].stop + tkey_bits.COUNT_LINES)
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
    parts = tkey_bits.lookback_partitions(padded)
    size = tkey_bits.LOOKBACK_PARTITION
    assert (parts - 1) * size < padded <= parts * size
    assert tkey_bits.lookback_words(num_tiles, cfg) == 2 * parts * cfg.radix + cfg.num_passes
    if num_tiles < 100:  # sort_plan allocates it so
        state = tkey_bits.sort_plan(torch.zeros(padded, dtype=torch.uint32), cfg,
                                    torch.zeros(1, dtype=torch.int64))
        assert state.lookback.numel() == 2 * parts * cfg.radix + cfg.num_passes


def test_lookback_partition_is_the_kernels():
    # The scratch is sized on the host for the kernel's partition
    # (kPartThreads x kPartItems keys); the entry point refuses a shorter one.
    src = (pathlib.Path(tscatter.__file__).parents[1] / "csrc" / "bucketize_scatter.cu").read_text()
    consts = {name: int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
              for name in ("kPartThreads", "kPartItems")}
    assert consts["kPartThreads"] * consts["kPartItems"] == tkey_bits.LOOKBACK_PARTITION


def test_sort_plan_and_lookback_plain_launch_nothing(rng):
    cfg = EngineConfig()
    wrappers = (tkey_bits.sort_plan, tscatter.bucketize_scatter_lookback, tkey_bits.key_bits)
    before = [w.launches for w in wrappers]
    keys = torch.from_numpy(rng.integers(0, 2**32, cfg.block, dtype=np.uint32))
    state = tkey_bits.sort_plan(keys, cfg, torch.zeros(1, dtype=torch.int64))
    tscatter.bucketize_scatter_lookback(keys, keys, cfg, state, 0)
    assert [w.launches for w in wrappers] == before


@pytest.mark.parametrize("route", ROUTES)
def test_lookback_pass_reads_and_writes_the_named_buffers(route, rng):
    # Pass 1 of a plan routes the look-back pass as it routes
    # bucketize_scatter: it writes the named destination as its unplanned
    # call on the named source would, and no other buffer.
    cfg = EngineConfig()
    n = 2 * cfg.tile

    def pair():
        return (torch.from_numpy(rng.integers(0, 2**32, n, dtype=np.uint32)),
                torch.from_numpy(rng.permutation(n).astype(np.uint32)))

    sources = (pair(), pair(), pair())  # the input, R, S
    before = [tuple(t.clone() for t in p) for p in sources]
    entry = tradix.PLAN_SKIP if ROUTES[route] is None else tradix.plan_entry(*ROUTES[route])
    state = tkey_bits.sort_plan(sources[0][0], cfg, torch.zeros(1, dtype=torch.int64))
    state = state._replace(plan=torch.tensor(
        [tradix.plan_entry(tradix.INPUT, tradix.RESULT), entry] + [-1] * 6, dtype=torch.int32))
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
        tkey_bits.sort_plan(keys, EngineConfig(radix_bits=8), skipped)
    with pytest.raises(ValueError, match="multiple of the tile"):
        tkey_bits.sort_plan(keys[:100], cfg, skipped)
    with pytest.raises(ValueError, match="skipped"):
        tkey_bits.sort_plan(keys, cfg, skipped.to(torch.int32))
    with pytest.raises(ValueError, match="CUDA tensor"):
        tkey_bits.sort_plan(keys, cfg, skipped, impl="cuda")
    state = tkey_bits.sort_plan(keys, cfg, skipped)
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
        tkey_bits.sort_plan(keys, cfg, torch.zeros(1, dtype=torch.int64, device="meta"))
    state = tkey_bits.SortPlan(*(torch.empty(0, dtype=torch.int32, device="meta"),) * 4)
    with pytest.raises(ValueError, match=r"2\^31.*int32"):
        tscatter.bucketize_scatter_lookback(keys, keys, cfg, state, 0)
