"""Per-pass radix-sort kernels, histogram half: digit histograms and offsets.

The PyTorch counterpart of ``gpuradixsort_tpu/kernels/radix.py``.
``tile_histograms`` launches the CUDA kernel ``csrc/radix_hist.cu`` on a CUDA
tensor and runs its plain version on a CPU tensor.  ``global_offsets`` is
plain tensor code, as it is plain jnp in the JAX package.

Buffers are 1-D: a tile is a contiguous stretch of ``cfg.tile`` keys, which
is what the JAX package's row-major ``(rows, 128)`` view makes of it.  Tables
are ``(num_tiles, radix)`` int32; the JAX package pads them to 128 lanes, so
they equal its tables' first ``radix`` columns.
"""

from __future__ import annotations

import torch

from gpuradixsort_tpu_torch.config import EngineConfig, resolve_impl
from gpuradixsort_tpu_torch.core.table import int32_bits
from gpuradixsort_tpu_torch.kernels._build import launch


def digits_of(keys: torch.Tensor, shift: int, radix: int) -> torch.Tensor:
    """(keys >> shift) & (radix - 1) as int64.

    uint32 has no shift in PyTorch, so the bits are widened to int64 first.
    """
    wide = int32_bits(keys).to(torch.int64) & 0xFFFFFFFF
    return (wide >> shift) & (radix - 1)


def check_keys(name: str, t: torch.Tensor, cfg: EngineConfig) -> int:
    """Check a kernel's 1-D uint32 buffer; return its number of tiles."""
    if t.dtype != torch.uint32 or t.dim() != 1 or not t.is_contiguous():
        raise ValueError(
            f"{name} must be a contiguous 1-D torch.uint32 tensor, got "
            f"{t.dtype} of shape {tuple(t.shape)}"
        )
    if t.numel() % cfg.tile:
        raise ValueError(
            f"{name} length {t.numel()} is not a multiple of the tile "
            f"{cfg.tile}; pad with core.table.pad_to_tile first"
        )
    return t.numel() // cfg.tile


def _tile_histograms_ref(keys: torch.Tensor, shift: int, cfg: EngineConfig):
    """Plain version: count each digit per tile."""
    num_tiles = keys.numel() // cfg.tile
    digits = digits_of(keys, shift, cfg.radix).view(num_tiles, cfg.tile)
    tile_of = torch.arange(num_tiles, device=keys.device)[:, None] * cfg.radix
    counts = torch.bincount((digits + tile_of).view(-1), minlength=num_tiles * cfg.radix)
    return counts.view(num_tiles, cfg.radix).to(torch.int32)


def tile_histograms(
    keys: torch.Tensor, shift: int, cfg: EngineConfig, impl: str | None = None
) -> torch.Tensor:
    """Per-tile digit histograms.

    keys: (num_tiles * tile,) uint32.  Returns (num_tiles, radix) int32 with
    hist[t, r] = number of keys in tile t whose digit is r.
    """
    num_tiles = check_keys("keys", keys, cfg)
    if resolve_impl(keys, impl) == "reference":
        return _tile_histograms_ref(keys, shift, cfg)
    hist = torch.empty((num_tiles, cfg.radix), dtype=torch.int32, device=keys.device)
    launch(
        "grs_radix_hist", keys, keys.data_ptr(), hist.data_ptr(), num_tiles,
        cfg.tile, shift, cfg.radix,
    )
    tile_histograms.launches += 1
    return hist


tile_histograms.launches = 0


def global_offsets(hist: torch.Tensor) -> torch.Tensor:
    """(num_tiles, radix) histograms -> (num_tiles, radix) global offsets.

    Stable LSD order is digit-major, then tile-major: bucket r of tile t
    starts after every key of buckets < r (all tiles) and of bucket r in
    earlier tiles.  That is the exclusive scan of the table read in (digit,
    tile) order, taken here as one 1-D cumsum: PyTorch scans a column of a
    2-D tensor one element after another, which at 16K tiles costs
    milliseconds on a GPU.
    """
    num_tiles, radix = hist.shape
    by_digit = hist.t().contiguous().view(-1)
    incl = torch.cumsum(by_digit, dim=0, dtype=torch.int64)
    excl = (incl - by_digit).to(torch.int32)
    return excl.view(radix, num_tiles).t().contiguous()
