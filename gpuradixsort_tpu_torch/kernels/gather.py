"""Payload gather: the columns of a table pulled through one index, ``gather_columns``.

Replaces no Pallas kernel: the JAX package gathers a sort's and a join's
payload columns with ``jnp.take``.  On CUDA tensors ``gather_columns``
launches ``csrc/gather_rows.cu`` once a column.  The kernel reads the index
as it lies (int32 or int64), clips it in registers, and reads it only below
the live length the caller gives: the rows past it are the column's row 0,
what a pad row's PAD_INDEX (-1 as int32, clipped to 0) gathers, written
from row 0 with no read of the index.  On CPU tensors it runs the plain
version, ``_gather_columns_ref``: ``ops/permute.py::gather_rows`` (an
``index_select`` through the clipped index) of the live rows, row 0 over
the rest, the rows the kernel walks.
"""

from __future__ import annotations

from typing import Sequence

import torch

from gpuradixsort_tpu_torch.config import resolve_impl
from gpuradixsort_tpu_torch.core.table import int32_bits
from gpuradixsort_tpu_torch.kernels._build import launch, unit_bytes
from gpuradixsort_tpu_torch.ops.permute import gather_rows

INDEX_DTYPES = (torch.int32, torch.int64)
MAX_UNITS_ROW = 1 << 20  # units of a row the kernel takes: its run's units fit an int


def _check(values: list, src: torch.Tensor, live: int | None) -> int:
    """Check the inputs; return the live length."""
    if src.dim() != 1 or src.dtype not in INDEX_DTYPES:
        raise ValueError(f"src must be a 1-D int32 or int64 index, got {src.dtype} of "
                         f"shape {tuple(src.shape)}")
    n = src.numel()
    live = n if live is None else live
    if not 0 <= live <= n:
        raise ValueError(f"live must lie in [0, {n}], got {live}")
    for v in values:
        if v.dim() < 1 or v.device != src.device:
            raise ValueError(f"each column must have rows and lie on {src.device}, got shape "
                             f"{tuple(v.shape)} on {v.device}")
        if n and not v.shape[0]:
            raise ValueError("cannot gather rows of a column that has none")
    return live


def _gather_columns_ref(values: list, src: torch.Tensor, live: int) -> list[torch.Tensor]:
    """The plain version: the live rows by ``index_select``, row 0 past them."""
    out = []
    for v in values:
        bits = int32_bits(v)
        o = torch.empty((src.numel(), *v.shape[1:]), dtype=bits.dtype, device=v.device)
        o[:live] = gather_rows(bits, src[:live])
        o[live:] = bits[:1]
        out.append(o.view(v.dtype))
    return out


def gather_columns(values: Sequence[torch.Tensor], src: torch.Tensor, live: int | None = None,
                   impl: str | None = None) -> list[torch.Tensor]:
    """out[i] = v[clip(src[i], 0, rows - 1)] for i < ``live``, v[0] from ``live`` on, for each v.

    ``src``: a 1-D int32 or int64 index of the output's n rows, read as it
    lies (a uint32 permutation is passed as its int32 view, so PAD_INDEX
    reads -1); ``live``: the rows of it that are read, a host integer from 0
    to n, None for all n.  Each value (1-D, or 2-D and wider rows of any
    dtype) lies on ``src``'s device and has at least one row where n > 0.
    Returns new tensors of n rows, each its value's dtype and row shape.

    On the card, one launch of ``csrc/gather_rows.cu`` a column, each
    reading the index below ``live`` again.
    """
    values = list(values)
    live = _check(values, src, live)
    if resolve_impl(src, impl) == "reference":
        return _gather_columns_ref(values, src, live)
    n = src.numel()
    src = src.contiguous()
    values = [v.contiguous() for v in values]
    out = [torch.empty((n, *v.shape[1:]), dtype=v.dtype, device=v.device) for v in values]
    for v, o in zip(values, out):
        row_bytes = v[:1].nbytes
        if not (n and row_bytes):
            continue
        unit = unit_bytes(v, row_bytes=row_bytes)
        if row_bytes // unit > MAX_UNITS_ROW:
            raise ValueError(f"rows of {row_bytes} bytes are wider than the kernel takes")
        launch("grs_gather_rows", src, src.data_ptr(), src.element_size(), n, live,
               v.data_ptr(), v.shape[0], row_bytes // unit, unit, o.data_ptr())
        gather_columns.launches += 1
    return out


gather_columns.launches = 0
