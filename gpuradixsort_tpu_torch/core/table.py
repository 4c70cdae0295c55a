"""Columnar device buffers: padded columns plus their live row counts.

The PyTorch counterpart of ``gpuradixsort_tpu/core/table.py``.  Each column is
one tensor padded to a multiple of ``EngineConfig.block`` rows, with the live
row count kept on the host.  The padded lengths, pad values and dtypes are
the JAX package's, bit for bit, so a table can be carried across
(``table_from_jax``) and both engines compared element for element.

PyTorch has few operators for ``torch.uint32`` (no shift, compare, gather or
indexed store on the CPU), so code that moves uint32 data views it as int32
with ``int32_bits``; the bits are unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from gpuradixsort_tpu_torch.config import PAD_KEY, TILES_PER_STEP, EngineConfig, default_device
from gpuradixsort_tpu_torch.utils import trace

# JAX runs with 64-bit types disabled, so it narrows 64-bit host data.
_NARROW = {
    np.dtype(np.int64): np.dtype(np.int32),
    np.dtype(np.uint64): np.dtype(np.uint32),
    np.dtype(np.float64): np.dtype(np.float32),
    np.dtype(np.complex128): np.dtype(np.complex64),
}


def round_up(n: int, multiple: int) -> int:
    """Smallest multiple of ``multiple`` that is >= n (and >= multiple)."""
    return max(((n + multiple - 1) // multiple) * multiple, multiple)


def check_padded_rows(padded: int, tile: int) -> None:
    """Raise ValueError for a buffer of more than 2^31 - one block of rows.

    A block is ``TILES_PER_STEP`` tiles of ``tile`` rows (``EngineConfig.block``).
    A sort's offsets, destinations and row indices and a filter's count are
    int32, so 2^31 rows would wrap them; K3 also needs a tile of headroom
    below 2^31 - 1.  Buffers padded to whole blocks pass up to 2^31 - block,
    so for them the limit is fewer than 2^31 rows.
    """
    block = tile * TILES_PER_STEP
    if padded > 2**31 - block:
        raise ValueError(
            f"{padded} padded rows: the port takes at most 2^31 - {block} "
            "(2^31 less one block), because its offsets, destinations, row "
            "indices and counts are int32"
        )


def int32_bits(t: torch.Tensor) -> torch.Tensor:
    """A uint32 tensor viewed as int32 (same bits); other dtypes unchanged."""
    return t.view(torch.int32) if t.dtype == torch.uint32 else t


def wide_keys(keys: torch.Tensor) -> torch.Tensor:
    """uint32 keys as int64 values, which ``torch.searchsorted``, compares and arithmetic take."""
    return int32_bits(keys).to(torch.int64) & 0xFFFFFFFF


def uint32_as_int32(value: int) -> int:
    """The int32 with the same bits as a uint32 value."""
    return value - (1 << 32) if value >= (1 << 31) else value


def wrap_int32(wide: torch.Tensor) -> torch.Tensor:
    """The int32 with the low 32 bits of each int64 (two's complement wrap)."""
    return (((wide + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).to(torch.int32)


def _full(shape, fill, dtype: torch.dtype, device) -> torch.Tensor:
    if dtype == torch.uint32:
        bits = uint32_as_int32(int(fill))
        return torch.full(shape, bits, dtype=torch.int32, device=device).view(dtype)
    return torch.full(shape, fill, dtype=dtype, device=device)


def pad_to_tile(arr: torch.Tensor, cfg: EngineConfig, fill) -> torch.Tensor:
    """Pad a tensor's first axis up to a multiple of ``cfg.block`` with ``fill``."""
    n = arr.shape[0]
    padded = round_up(n, cfg.block)
    if padded == n:
        return arr
    tail = _full((padded - n,) + tuple(arr.shape[1:]), fill, arr.dtype, arr.device)
    return torch.cat([int32_bits(arr), int32_bits(tail)]).view(arr.dtype)


def _pad_numpy(arr: np.ndarray, cfg: EngineConfig, fill) -> np.ndarray:
    n = arr.shape[0]
    out = np.full((round_up(n, cfg.block),) + arr.shape[1:], fill, dtype=arr.dtype)
    out[:n] = arr
    return out


@dataclasses.dataclass(frozen=True)
class Column:
    """One column: padded data + live row count.

    ``data`` has shape (padded_length, ...); rows >= ``length`` are pad rows.
    """

    data: torch.Tensor
    length: int

    def __post_init__(self):
        if self.length > self.data.shape[0]:
            raise ValueError(
                f"length {self.length} exceeds buffer size {self.data.shape[0]}"
            )

    @property
    def padded_length(self) -> int:
        return self.data.shape[0]

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    @property
    def device(self) -> torch.device:
        return self.data.device

    def valid(self) -> torch.Tensor:
        """The live (unpadded) prefix."""
        return self.data[: self.length]

    def to_numpy(self) -> np.ndarray:
        """The live prefix on the host, in the dtype the JAX package gives (``grs.column.sync``)."""
        with trace.span("grs.column.sync"):
            return self.valid().cpu().numpy()


def make_column(
    values, cfg: EngineConfig | None = None, fill=0, dtype=None, device=None
) -> Column:
    """Build a padded Column from host values or a tensor.

    Host values are converted to ``dtype`` (a numpy dtype) if given, and take
    JAX's dtypes (64-bit types narrow to 32 bits); they go to ``device``, by
    default the CUDA card (``config.default_device``).  A tensor keeps its
    dtype, and its device unless ``device`` is given.
    """
    cfg = cfg or EngineConfig()
    if isinstance(values, torch.Tensor):
        if dtype is not None:
            raise TypeError("dtype applies to host values; convert a tensor with .to()")
        arr = values.to(device) if device is not None else values
        return Column(pad_to_tile(arr, cfg, fill), arr.shape[0])
    arr = np.asarray(values, dtype=dtype)
    arr = arr.astype(_NARROW.get(arr.dtype, arr.dtype), copy=False)
    data = torch.from_numpy(_pad_numpy(arr, cfg, fill)).to(default_device(device))
    return Column(data, arr.shape[0])


def make_key_column(
    values, cfg: EngineConfig | None = None, device=None
) -> Column:
    """A uint32 sort-key column, padded with PAD_KEY so pads sort last.

    Raises ValueError, before it pads or copies anything, when the padded
    column would have 2^31 rows or more (``check_padded_rows``).
    """
    cfg = cfg or EngineConfig()
    check_padded_rows(round_up(len(values), cfg.block), cfg.tile)
    if isinstance(values, torch.Tensor):
        if values.dtype != torch.uint32:
            raise TypeError(f"key tensor must be torch.uint32, got {values.dtype}")
        return make_column(values, cfg, fill=PAD_KEY, device=device)
    return make_column(values, cfg, fill=PAD_KEY, dtype=np.uint32, device=device)


@dataclasses.dataclass(frozen=True)
class Table:
    """A named collection of equal-length columns."""

    columns: Mapping[str, Column]

    def __post_init__(self):
        lengths = {c.length for c in self.columns.values()}
        if len(lengths) > 1:
            raise ValueError(f"ragged table: column lengths {lengths}")

    @property
    def length(self) -> int:
        return next(iter(self.columns.values())).length if self.columns else 0

    def __getitem__(self, name: str) -> Column:
        return self.columns[name]

    def names(self):
        return list(self.columns.keys())

    def with_column(self, name: str, col: Column) -> "Table":
        cols = dict(self.columns)
        cols[name] = col
        return Table(cols)


def table_from_arrays(cfg: EngineConfig | None = None, device=None, **arrays) -> Table:
    cfg = cfg or EngineConfig()
    return Table({k: make_column(v, cfg, device=device) for k, v in arrays.items()})


def column_from_jax(col, device=None) -> Column:
    """Carry a ``gpuradixsort_tpu`` Column across: padded buffer bit for bit.

    The buffer goes to ``device``, by default the CUDA card.
    """
    data = torch.from_numpy(np.array(col.data)).to(default_device(device))
    return Column(data, col.length)


def table_from_jax(tbl, device=None) -> Table:
    """Carry a ``gpuradixsort_tpu`` Table across, column by column."""
    return Table({k: column_from_jax(c, device) for k, c in tbl.columns.items()})
