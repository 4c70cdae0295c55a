"""Bucketize: stable sort of every tile's (key, index) pairs by the digit.

The PyTorch counterpart of ``gpuradixsort_tpu/kernels/bucketize.py``.  After
it runs, every tile is digit-major, so the global scatter of
``kernels/scatter.py`` copies whole runs.  On a CUDA tensor it launches
``csrc/bucketize.cu``, one warp per tile ranking in registers and staging
the tile in shared memory; on a CPU tensor it runs the plain version, a
per-tile stable argsort by digit.  The fused sort's passes run
``kernels/scatter.py::bucketize_scatter_lookback``, which ranks a partition
and places it without the round trip through device memory;
``bucketize_tiles`` stays as the counterpart of the JAX package's function.
"""

from __future__ import annotations

import torch

from gpuradixsort_tpu_torch.config import EngineConfig, resolve_impl
from gpuradixsort_tpu_torch.core.table import int32_bits
from gpuradixsort_tpu_torch.kernels._build import launch
from gpuradixsort_tpu_torch.kernels.radix import (
    MAX_SHARED_BYTES,
    WARP,
    check_keys,
    digits_of,
)

BUCKETIZE_TILES_PER_BLOCK = 2
# The tile of the kernel's fast route, whose warps also stage their input.
FAST_TILE = 1024


def _bucketize_ref(keys: torch.Tensor, idx: torch.Tensor, shift: int, cfg: EngineConfig):
    """Plain version: per-tile argsort(digit, stable) applied to key and index."""
    num_tiles = keys.numel() // cfg.tile
    digits = digits_of(keys, shift, cfg.radix).view(num_tiles, cfg.tile)
    order = torch.argsort(digits, dim=1, stable=True)

    def take(t):
        rows = int32_bits(t).view(num_tiles, cfg.tile)
        return torch.take_along_dim(rows, order, dim=1).view(-1).view(t.dtype)

    return take(keys), take(idx)


def bucketize_geometry(cfg: EngineConfig) -> tuple[int, int]:
    """(threads, shared bytes) of a bucketize_tiles block.

    One warp per tile, up to ``BUCKETIZE_TILES_PER_BLOCK`` tiles a block;
    each stages its tile's sorted keys and indices (8 bytes a key) in shared
    memory, and on the 1,024-key tile also the next tile's input (16 bytes
    a key in all).
    """
    per_tile = (16 if cfg.tile == FAST_TILE else 8) * cfg.tile
    tiles = min(BUCKETIZE_TILES_PER_BLOCK, MAX_SHARED_BYTES // per_tile)
    if tiles == 0:
        raise ValueError(
            f"bucketize stages {per_tile} bytes a tile, more than a block's "
            f"{MAX_SHARED_BYTES}; use tile_rows <= {MAX_SHARED_BYTES // (8 * 128)}"
        )
    return WARP * tiles, tiles * per_tile


def bucketize_tiles(
    keys: torch.Tensor,
    idx: torch.Tensor,
    shift: int,
    cfg: EngineConfig,
    impl: str | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Stable-sort every tile by digit.  keys, idx: (num_tiles * tile,) uint32."""
    if cfg.radix > 16:
        raise ValueError("bucketize supports radix <= 16")
    num_tiles = check_keys("keys", keys, cfg)
    check_keys("idx", idx, cfg)
    if idx.numel() != keys.numel() or idx.device != keys.device:
        raise ValueError("keys and idx must have one length and one device")
    if resolve_impl(keys, impl) == "reference":
        return _bucketize_ref(keys, idx, shift, cfg)
    threads, _ = bucketize_geometry(cfg)
    out_keys = torch.empty_like(keys)
    out_idx = torch.empty_like(idx)
    launch(
        "grs_bucketize", keys, keys.data_ptr(), idx.data_ptr(),
        out_keys.data_ptr(), out_idx.data_ptr(), num_tiles, cfg.tile,
        threads, shift, cfg.radix,
    )
    bucketize_tiles.launches += 1
    return out_keys, out_idx


bucketize_tiles.launches = 0
