"""Helpers of the query plans: sort keys of non-negative int32 values, and a LIMIT."""

from __future__ import annotations

import torch

from gpuradixsort_tpu_torch.core.table import Column

INT32_MAX = 2**31 - 1


def as_key(t: torch.Tensor) -> torch.Tensor:
    """Non-negative int32 values as a uint32 sort key (the same bits)."""
    return t.view(torch.uint32)


def head(col: Column, limit: int) -> Column:
    """The column's first ``limit`` live rows."""
    return Column(col.data, min(limit, col.length))
