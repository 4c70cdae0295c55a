"""Stable LSD radix sort over columnar buffers.

The PyTorch counterpart of ``gpuradixsort_tpu/ops/sort.py``.  Methods:

- ``"fused"``: ``cfg.num_passes`` passes, each one histogram kernel, the
  offsets scan, one bucketize kernel and one scatter kernel.  Takes 1-, 2-
  and 4-bit digits.
- ``"radix"``: ``cfg.num_passes`` passes, each one histogram kernel, the
  offsets scan, one destination kernel and one indexed store per column
  (``permute.scatter_by_destination``).  Takes digits up to 8 bits, and has
  no constant-digit skip, as in the JAX package.
- ``"auto"``: ``"radix"`` for 8-bit digits, which the fused bucketize does
  not take, else ``"fused"``.  A stable sort has one answer, so this gives
  the JAX package's result wherever its ``"auto"`` sorts.
- ``"torch"``: the library baseline, ``torch.sort(stable=True)``, standing
  where the JAX package's ``lax.sort`` method stands.  Never the main path.

On CUDA tensors every pass runs the CUDA kernels; on CPU tensors their plain
versions.  Nothing but ``"torch"`` calls ``torch.sort``.

The JAX package falls back to a whole ``lax.sort`` when a run overflows the
TPU scatter window.  The CUDA scatter has no window, so there is no
fall-back here.
"""

from __future__ import annotations

import torch

from gpuradixsort_tpu_torch.config import PAD_INDEX, PAD_KEY, EngineConfig
from gpuradixsort_tpu_torch.core.table import (
    Column,
    Table,
    check_padded_rows,
    int32_bits,
    make_key_column,
    uint32_as_int32,
)
from gpuradixsort_tpu_torch.kernels import radix as radix_kernels
from gpuradixsort_tpu_torch.kernels.bucketize import bucketize_tiles
from gpuradixsort_tpu_torch.kernels.scatter import scatter_runs
from gpuradixsort_tpu_torch.ops.permute import gather_rows, scatter_by_destination

METHODS = ("auto", "fused", "torch", "radix")


def _fused_pass(keys: torch.Tensor, idx: torch.Tensor, shift: int, cfg: EngineConfig):
    """One pass: histogram -> offsets -> bucketize -> scatter.

    A pass whose digit is the same for every key is the identity and is
    skipped.  Deciding that reads one flag back to the host, so each pass
    synchronises with the device once.  Returns (keys, idx, ran).
    """
    hist = radix_kernels.tile_histograms(keys, shift, cfg)
    if int(torch.count_nonzero(hist.sum(dim=0))) <= 1:
        return keys, idx, False
    offsets = radix_kernels.global_offsets(hist)
    bk, bi = bucketize_tiles(keys, idx, shift, cfg)
    out_keys, out_idx, _ = scatter_runs(bk, bi, hist, offsets, cfg)
    return out_keys, out_idx, True


def _fused_sort_padded(keys: torch.Tensor, idx: torch.Tensor, cfg: EngineConfig):
    """Stable (key, index) sort of padded 1-D uint32 buffers.

    Returns (keys, idx, overflow); overflow is always False (no window).
    Adds the number of skipped passes to ``_fused_sort_padded.skipped_passes``.
    """
    for p in range(cfg.num_passes):
        keys, idx, ran = _fused_pass(keys, idx, p * cfg.radix_bits, cfg)
        if not ran:
            _fused_sort_padded.skipped_passes += 1
    return keys, idx, False


_fused_sort_padded.skipped_passes = 0


def _radix_pass(keys: torch.Tensor, carried: tuple, shift: int,
                cfg: EngineConfig) -> tuple[torch.Tensor, tuple]:
    """One stable counting pass on digit (keys >> shift) & (radix - 1).

    keys: (padded,) uint32; carried: tensors of the same rows, permuted
    alongside.  Returns (keys, carried) reordered by the digit, stably.
    """
    hist = radix_kernels.tile_histograms(keys, shift, cfg)
    offsets = radix_kernels.global_offsets(hist)
    dest = radix_kernels.tile_destinations(keys, offsets, shift, cfg)
    out = scatter_by_destination(dest, [keys, *carried])
    return out[0], tuple(out[1:])


def _sort_padded(keys: torch.Tensor, carried: tuple,
                 cfg: EngineConfig) -> tuple[torch.Tensor, tuple]:
    """The radix method: stable sort of padded keys, carrying other columns.

    The JAX package's ``strategy`` picks how a TPU applies the permutation
    and its ``num_carried`` keys its jit cache; neither means anything on
    the GPU, so the port takes neither.
    """
    for p in range(cfg.num_passes):
        keys, carried = _radix_pass(keys, carried, p * cfg.radix_bits, cfg)
    return keys, carried


def _torch_sort_padded(keys: torch.Tensor, idx: torch.Tensor):
    """Library baseline: one stable ``torch.sort`` of the padded keys.

    ``torch.sort`` takes no uint32 on CUDA, so it sorts the keys widened to
    int64, and the keys and indices follow through the order.
    """
    wide = int32_bits(keys).to(torch.int64) & 0xFFFFFFFF
    order = torch.sort(wide, stable=True).indices
    return gather_rows(keys, order), gather_rows(idx, order)


def _resolve_method(method: str, cfg: EngineConfig) -> str:
    if method not in METHODS:
        raise ValueError(f"unknown sort method: {method}")
    if method == "auto":
        return "radix" if cfg.radix > 16 else "fused"
    return method


def _index_column(col: Column) -> torch.Tensor:
    """0..length-1 as uint32, then PAD_INDEX over the pad rows."""
    pos = torch.arange(col.padded_length, dtype=torch.int32, device=col.device)
    return torch.where(pos < col.length, pos, uint32_as_int32(PAD_INDEX)).view(torch.uint32)


def _sort_column(col: Column, cfg: EngineConfig, method: str):
    """(sorted keys, permutation) of a padded key column by one method."""
    idx = _index_column(col)
    if method == "fused":
        keys, perm, _ = _fused_sort_padded(col.data, idx, cfg)
        return keys, perm
    if method == "radix":
        keys, (perm,) = _sort_padded(col.data, (idx,), cfg)
        return keys, perm
    return _torch_sort_padded(col.data, idx)


def sort_keys(
    keys, cfg: EngineConfig | None = None, method: str = "auto", device=None,
) -> Column:
    """Sort a uint32 key column ascending, stably.  Returns a new Column.

    ``keys`` is a Column, a uint32 tensor or host values.  Host values go to
    ``device``, by default the CUDA card; without a card they raise unless
    ``device="cpu"``.
    """
    cfg = cfg or EngineConfig()
    method = _resolve_method(method, cfg)
    col = _as_key_column(keys, cfg, device)
    if method == "radix":  # no index column to carry
        sorted_keys, _ = _sort_padded(col.data, (), cfg)
    else:
        sorted_keys, _ = _sort_column(col, cfg, method)
    return Column(sorted_keys, col.length)


def sort_pairs(
    keys, cfg: EngineConfig | None = None, method: str = "auto", device=None,
) -> tuple[Column, Column]:
    """Sort (key, original-row-index) pairs.

    The index column starts as 0..N-1 and ends as the permutation that sorts
    the keys; pad rows carry PAD_INDEX.  Stability keeps equal keys in their
    original order and live rows before pad rows, even where a live key
    equals PAD_KEY.  ``keys`` and ``device`` are as in ``sort_keys``.
    """
    cfg = cfg or EngineConfig()
    method = _resolve_method(method, cfg)
    col = _as_key_column(keys, cfg, device)
    sorted_keys, perm = _sort_column(col, cfg, method)
    return Column(sorted_keys, col.length), Column(perm, col.length)


def sort_table(
    table: Table, key: str, cfg: EngineConfig | None = None, method: str = "auto",
) -> Table:
    """Sort a whole table by one uint32 key column, stably.

    Sorts (key, index) pairs, then gathers every payload column through the
    sorted index.  As in the JAX package, the index is read as int32, so a
    pad row's PAD_INDEX becomes -1 and is clipped to row 0; pad rows lie past
    ``length``.
    """
    cfg = cfg or EngineConfig()
    sorted_keys, perm = sort_pairs(table[key], cfg, method)
    src = int32_bits(perm.data)
    out = {key: sorted_keys}
    for name in table.names():
        if name != key:
            col = table[name]
            out[name] = Column(gather_rows(col.data, src), col.length)
    return Table(out)


def _as_key_column(keys, cfg: EngineConfig, device=None) -> Column:
    """The padded key column every sort starts from; 2^31 padded rows or more raise."""
    if not isinstance(keys, Column):
        return make_key_column(keys, cfg, device=device)
    if keys.dtype != torch.uint32 or keys.data.dim() != 1:
        raise ValueError(f"key column must be 1-D torch.uint32, got {keys.dtype}")
    check_padded_rows(keys.padded_length, cfg.tile)
    if keys.length == keys.padded_length:
        return keys
    # Rows past the live prefix may hold anything; re-assert the pad key so
    # they sort to the back.
    pos = torch.arange(keys.padded_length, device=keys.device)
    data = torch.where(pos < keys.length, int32_bits(keys.data), uint32_as_int32(PAD_KEY))
    return Column(data.view(torch.uint32), keys.length)
