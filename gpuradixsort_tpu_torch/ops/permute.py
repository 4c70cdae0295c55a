"""Payload permutation: pull rows through a sorted index.

The PyTorch counterpart of ``gpuradixsort_tpu/ops/permute.py::gather_rows``,
a plain ``jnp.take`` there and a plain index-select here.
"""

from __future__ import annotations

import torch

from gpuradixsort_tpu_torch.core.table import int32_bits


def gather_rows(values: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """out[i] = values[src[i]], with src clipped to the rows of ``values``."""
    src = src.to(torch.int64).clamp(0, values.shape[0] - 1)
    return int32_bits(values).index_select(0, src).view(values.dtype)
