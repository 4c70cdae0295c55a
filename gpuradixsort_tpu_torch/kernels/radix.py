"""Per-pass radix-sort kernels: digit histograms, offsets and destinations.

The PyTorch counterpart of ``gpuradixsort_tpu/kernels/radix.py``.
``tile_histograms`` launches ``csrc/radix_hist.cu`` and ``tile_destinations``
launches ``csrc/radix_dest.cu`` on a CUDA tensor; on a CPU tensor each runs
its plain version.  ``global_offsets`` is one exclusive scan
(``kernels/scan.py``, a CUDA kernel on a CUDA tensor) between two
transposes, where the JAX package has plain jnp cumsums.

``dest_scatter`` is K4 and the indexed stores the JAX package runs after it
(``ops/permute.py::scatter_by_destination``) as one kernel of
``csrc/radix_dest.cu``: a block ranks a partition of consecutive tiles and
writes every moved column's rows at their destinations, each digit's rows
of the partition as one run, with no destination buffer.  The radix method's
passes and every compaction run it; ``tile_destinations`` stays as the
counterpart of the JAX package's ``_dest_kernel`` and runs on no path.

Buffers are 1-D: a tile is a contiguous stretch of ``cfg.tile`` keys, which
is what the JAX package's row-major ``(rows, 128)`` view makes of it.  Tables
are ``(num_tiles, radix)`` int32; the JAX package pads them to 128 lanes, so
they equal its tables' first ``radix`` columns.
"""

from __future__ import annotations

import ctypes

import torch

from gpuradixsort_tpu_torch.config import EngineConfig, resolve_impl
from gpuradixsort_tpu_torch.core.table import check_padded_rows, int32_bits
from gpuradixsort_tpu_torch.kernels._build import launch, unit_bytes
from gpuradixsort_tpu_torch.kernels.scan import exclusive_scan
from gpuradixsort_tpu_torch.ops.permute import scatter_by_destination


def digits_of(keys: torch.Tensor, shift: int, radix: int) -> torch.Tensor:
    """(keys >> shift) & (radix - 1) as int64.

    uint32 has no shift in PyTorch, so the bits are widened to int64 first.
    """
    wide = int32_bits(keys).to(torch.int64) & 0xFFFFFFFF
    return (wide >> shift) & (radix - 1)


def check_keys(name: str, t: torch.Tensor, cfg: EngineConfig) -> int:
    """Check a kernel's 1-D uint32 buffer; return its number of tiles.

    A buffer of more than 2^31 less a block of elements is refused: the
    kernels' offsets and destinations are int32.
    """
    if t.dtype != torch.uint32 or t.dim() != 1 or not t.is_contiguous():
        raise ValueError(
            f"{name} must be a contiguous 1-D torch.uint32 tensor, got "
            f"{t.dtype} of shape {tuple(t.shape)}"
        )
    check_padded_rows(t.numel(), cfg.tile)
    if t.numel() % cfg.tile:
        raise ValueError(
            f"{name} length {t.numel()} is not a multiple of the tile "
            f"{cfg.tile}; pad with core.table.pad_to_tile first"
        )
    return t.numel() // cfg.tile


def check_table(name: str, t: torch.Tensor, keys: torch.Tensor, cfg: EngineConfig) -> None:
    """Check a (num_tiles, radix) int32 table of the checked 1-D buffer ``keys``."""
    shape = (keys.numel() // cfg.tile, cfg.radix)
    if t.dtype != torch.int32 or tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous int32 of shape {shape}, got "
                         f"{t.dtype} of shape {tuple(t.shape)}")
    if t.device != keys.device:
        raise ValueError(f"{name} must be on the keys' device {keys.device}, not {t.device}")


def data_ptr(t: torch.Tensor | None):
    """``t``'s address, or None (a null pointer) for no tensor."""
    return None if t is None else t.data_ptr()


# Launch geometry of the kernels, checked again by their C entry points.
WARP = 32
MAX_SHARED_BYTES = 232_448  # shared memory one block may use on the H100
HIST_TILES_PER_BLOCK = 8
DEST_TILES_PER_BLOCK = 2
DEST_SCATTER_TILES_PER_BLOCK = 8  # tiles of a dest_scatter partition, at most: a warp each
DEST_SCATTER_BLOCK_WARPS = 4  # a dest_scatter block's warps, where its partitions are one tile
DEST_SCATTER_RUN_ROWS = 32  # rows of a digit a partition should place as one run
DEST_SCATTER_MIN_BLOCKS = 132  # partitions a launch keeps where it can: one an H100 SM
MAX_PARTITION_ROWS = 1 << 16  # a dest_scatter partition's rows are staged in 16 bits
MAX_MOVED_COLUMNS = 8  # columns one dest_scatter launch moves


def hist_geometry(cfg: EngineConfig) -> tuple[int, int]:
    """(threads, shared bytes) of a tile_histograms block.

    One warp per tile, ``HIST_TILES_PER_BLOCK`` tiles a block.  Radixes up
    to 16 count in registers; larger ones keep a warp-private table in
    shared memory, one 8-bit field per (digit, lane): ``32 * radix`` bytes.
    """
    shared = HIST_TILES_PER_BLOCK * WARP * cfg.radix if cfg.radix > 16 else 0
    return WARP * HIST_TILES_PER_BLOCK, shared


def dest_geometry(cfg: EngineConfig) -> tuple[int, int]:
    """(threads, shared bytes) of a tile_destinations block.

    One warp per tile, ``DEST_TILES_PER_BLOCK`` tiles a block.  Radixes up
    to 32 keep each digit's running destination in one lane's register;
    larger ones in a warp-private shared table of ``radix`` int32.
    """
    shared = DEST_TILES_PER_BLOCK * 4 * cfg.radix if cfg.radix > WARP else 0
    return WARP * DEST_TILES_PER_BLOCK, shared


def dest_scatter_partition_bytes(radix: int, tile: int, per_block: int) -> int:
    """Shared bytes of one dest_scatter partition (``csrc/radix_dest.cu``, the same function).

    The position bases of each (tile, digit) of its ``per_block`` tiles and
    the delta of each digit (int32), then the partition's destinations
    (int32) and rows (16 bits) by position.  Rounded up to 16 bytes.
    """
    return -(-(4 * (per_block + 1) * radix + 6 * per_block * tile) // 16) * 16


def dest_scatter_tiles(cfg: EngineConfig, num_tiles: int) -> int:
    """The tiles of one dest_scatter partition: 1, 2, 4 or 8.

    The fewest whose digit runs, ``per_block * tile / radix`` rows, reach
    ``DEST_SCATTER_RUN_ROWS``: 1 for the default tile up to radix 32, 8 at
    radix 256.  Fewer where the launch would keep less than
    ``DEST_SCATTER_MIN_BLOCKS`` partitions, the partition's rows would not
    fit 16 bits or its staging a block's shared memory; down to one.
    """
    per_block = 1
    while per_block < DEST_SCATTER_TILES_PER_BLOCK and per_block * cfg.tile < (
            DEST_SCATTER_RUN_ROWS * cfg.radix):
        per_block *= 2
    while per_block > 1 and (
            -(-num_tiles // per_block) < DEST_SCATTER_MIN_BLOCKS
            or per_block * cfg.tile > MAX_PARTITION_ROWS
            or dest_scatter_partition_bytes(cfg.radix, cfg.tile, per_block) > MAX_SHARED_BYTES):
        per_block //= 2
    return per_block


def dest_scatter_geometry(cfg: EngineConfig, num_tiles: int) -> tuple[int, int, int]:
    """(threads, tiles a partition, shared bytes) of a dest_scatter block.

    A partition is ``dest_scatter_tiles`` consecutive tiles (the last may
    be ragged), one warp a tile.  A block is one partition, or, where a
    partition is one tile, as many as make ``DEST_SCATTER_BLOCK_WARPS``
    warps and fit its shared memory.  A tile whose staging alone exceeds a
    block's shared memory (about 38,000 keys) is refused.
    """
    per_block = dest_scatter_tiles(cfg, num_tiles)
    part = dest_scatter_partition_bytes(cfg.radix, cfg.tile, per_block)
    if part > MAX_SHARED_BYTES:
        raise ValueError(f"dest_scatter stages a tile in shared memory: {cfg.tile} keys at "
                         f"radix {cfg.radix} take {part} bytes, more than a block's "
                         f"{MAX_SHARED_BYTES}")
    partitions = min(DEST_SCATTER_BLOCK_WARPS, MAX_SHARED_BYTES // part) if per_block == 1 else 1
    return WARP * per_block * partitions, per_block, partitions * part


def _tile_histograms_ref(keys: torch.Tensor, shift: int, cfg: EngineConfig):
    """Plain version: count each digit per tile."""
    num_tiles = keys.numel() // cfg.tile
    digits = digits_of(keys, shift, cfg.radix).view(num_tiles, cfg.tile)
    tile_of = torch.arange(num_tiles, device=keys.device)[:, None] * cfg.radix
    counts = torch.bincount((digits + tile_of).view(-1), minlength=num_tiles * cfg.radix)
    return counts.view(num_tiles, cfg.radix).to(torch.int32)


def tile_histograms(keys: torch.Tensor, shift: int, cfg: EngineConfig,
                    impl: str | None = None) -> torch.Tensor:
    """Per-tile digit histograms.

    keys: (num_tiles * tile,) uint32.  Returns (num_tiles, radix) int32 with
    hist[t, r] = number of keys in tile t whose digit is r.
    """
    num_tiles = check_keys("keys", keys, cfg)
    if resolve_impl(keys, impl) == "reference":
        return _tile_histograms_ref(keys, shift, cfg)
    hist = torch.empty((num_tiles, cfg.radix), dtype=torch.int32, device=keys.device)
    threads, _ = hist_geometry(cfg)
    launch(
        "grs_radix_hist", keys, keys.data_ptr(), hist.data_ptr(), num_tiles,
        cfg.tile, threads, shift, cfg.radix,
    )
    tile_histograms.launches += 1
    return hist


tile_histograms.launches = 0


def _tile_destinations_ref(keys: torch.Tensor, offsets: torch.Tensor, shift: int,
                           cfg: EngineConfig) -> torch.Tensor:
    """Plain version: a per-tile stable argsort of the digits.

    In a tile's digit-sorted order, an element's rank within its digit is
    its position less the position of its digit's first element.  This
    avoids the JAX reference's one-hot (tiles, tile, radix) expansion.
    """
    num_tiles = keys.numel() // cfg.tile
    digits = digits_of(keys, shift, cfg.radix).view(num_tiles, cfg.tile)
    order = torch.argsort(digits, dim=1, stable=True)
    sorted_digits = torch.take_along_dim(digits, order, dim=1)
    first = torch.searchsorted(sorted_digits, sorted_digits, side="left")
    pos = torch.arange(cfg.tile, device=keys.device)
    dest_sorted = offsets.to(torch.int64).gather(1, sorted_digits) + pos - first
    dest = torch.empty_like(dest_sorted).scatter_(1, order, dest_sorted)
    return dest.view(-1).to(torch.int32)


def tile_destinations(
    keys: torch.Tensor,
    offsets: torch.Tensor,
    shift: int,
    cfg: EngineConfig,
    impl: str | None = None,
) -> torch.Tensor:
    """Stable global destination of every key for one radix pass.

    keys: (num_tiles * tile,) uint32; offsets: (num_tiles, radix) int32
    global base offsets (``global_offsets``).  Returns (num_tiles * tile,)
    int32 with dest[i] = offsets[t, digit_i] + the number of earlier keys of
    tile t with the same digit: a permutation of 0..N-1.
    """
    num_tiles = check_keys("keys", keys, cfg)
    check_table("offsets", offsets, keys, cfg)
    if resolve_impl(keys, impl) == "reference":
        return _tile_destinations_ref(keys, offsets, shift, cfg)
    dest = torch.empty(keys.numel(), dtype=torch.int32, device=keys.device)
    threads, _ = dest_geometry(cfg)
    launch(
        "grs_radix_dest", keys, keys.data_ptr(), offsets.data_ptr(), dest.data_ptr(),
        num_tiles, cfg.tile, threads, shift, cfg.radix,
    )
    tile_destinations.launches += 1
    return dest


tile_destinations.launches = 0


def dest_scatter(
    rank_keys: torch.Tensor,
    hist: torch.Tensor,
    offsets: torch.Tensor,
    shift: int,
    cfg: EngineConfig,
    values,
    impl: str | None = None,
) -> list[torch.Tensor]:
    """One stable radix pass's moves: out[dest[i]] = v[i] for every tensor v of ``values``.

    dest is ``tile_destinations(rank_keys, offsets, shift, cfg)``, computed
    inside the kernel and never stored.  rank_keys: (num_tiles * tile,)
    uint32; hist: (num_tiles, radix) int32, K1's table of rank_keys
    (``tile_histograms``); offsets: ``global_offsets(hist)``, of which the
    kernel reads only each partition's first row (the rest follows from
    hist).  Each value has rank_keys' rows (1-D, or 2-D and wider rows of
    any dtype), is contiguous and lies on their device.  Returns the moved
    tensors, new.

    On the card, one launch of ``csrc/radix_dest.cu`` moves up to
    ``MAX_MOVED_COLUMNS`` columns; more run further launches on the next
    group.  The plain version is ``_tile_destinations_ref`` then
    ``scatter_by_destination``.
    """
    values = list(values)
    num_tiles = check_keys("rank_keys", rank_keys, cfg)
    check_table("hist", hist, rank_keys, cfg)
    check_table("offsets", offsets, rank_keys, cfg)
    for v in values:
        if v.dim() < 1 or v.shape[0] != rank_keys.numel() or v.device != rank_keys.device:
            raise ValueError(f"each moved column must have rank_keys' {rank_keys.numel()} rows "
                             f"on {rank_keys.device}, got shape {tuple(v.shape)} on {v.device}")
        if not v.is_contiguous():
            raise ValueError("each moved column must be contiguous")
    if resolve_impl(rank_keys, impl) == "reference":
        dest = _tile_destinations_ref(rank_keys, offsets, shift, cfg)
        return scatter_by_destination(dest, values)
    threads, per_block, _ = dest_scatter_geometry(cfg, num_tiles)
    out = [torch.empty_like(v) for v in values]
    moved = []
    for v, o in zip(values, out):
        row_bytes = v[:1].nbytes if v.numel() else 0
        if row_bytes:
            unit = unit_bytes(v, o, row_bytes=row_bytes)
            moved.append((v.data_ptr(), o.data_ptr(), row_bytes // unit, unit))
    for first in range(0, len(moved), MAX_MOVED_COLUMNS):
        group = moved[first:first + MAX_MOVED_COLUMNS]
        words = (ctypes.c_int64 * (4 * len(group)))(*(w for column in group for w in column))
        launch(
            "grs_radix_dest_scatter", rank_keys, rank_keys.data_ptr(), hist.data_ptr(),
            offsets.data_ptr(), ctypes.addressof(words), len(group), num_tiles, cfg.tile,
            threads, per_block, shift, cfg.radix,
        )
        dest_scatter.launches += 1
    return out


dest_scatter.launches = 0


def global_offsets(hist: torch.Tensor) -> torch.Tensor:
    """(num_tiles, radix) histograms -> (num_tiles, radix) global offsets.

    Stable LSD order is digit-major, then tile-major: bucket r of tile t
    starts after every key of buckets < r (all tiles) and of bucket r in
    earlier tiles.  That is the exclusive scan of the table read in (digit,
    tile) order: one 1-D ``exclusive_scan``, never PyTorch's column scan of
    a 2-D tensor, which runs one element after another on a GPU.
    """
    num_tiles, radix = hist.shape
    excl, _ = exclusive_scan(hist.t().contiguous().view(-1))
    return excl.view(radix, num_tiles).t().contiguous()
