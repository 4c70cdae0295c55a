"""Payload permutation: rows pushed to computed destinations or pulled through an index.

The PyTorch counterpart of ``gpuradixsort_tpu/ops/permute.py``.  Both
directions are plain indexed moves on int32 views, as they are plain XLA
scatter and gather in the JAX package.  The JAX package also applies a
permutation as a key-value sort on the destinations (its ``strategy``
argument), because the TPU has no fast random store; the GPU has one, so
the port has one way and takes no strategy.

On the card no operator path runs ``scatter_by_destination``: a radix pass
and a compaction store their rows at their destinations inside one kernel,
``kernels/radix.py::dest_scatter``, whose plain version, the CPU's route,
is ``tile_destinations`` then this function.  Nor does any operator path
run ``gather_rows`` there: the operators gather through
``kernels/gather.py::gather_columns``, whose plain version builds on this
function.  ``gather_rows`` stays the plain gather of the references and of
the library baseline, on both.
"""

from __future__ import annotations

from typing import Sequence

import torch

from gpuradixsort_tpu_torch.core.table import int32_bits

def scatter_by_destination(
    dest: torch.Tensor, values: Sequence[torch.Tensor]
) -> list[torch.Tensor]:
    """out[dest[i]] = values[i] for each tensor in ``values`` (rows may be 2-D).

    ``dest`` must be a permutation of 0..N-1, as the radix pass builds it, so
    every output row is written.  One indexed store per tensor.
    """
    index = dest.to(torch.int64)
    out = []
    for v in values:
        bits = int32_bits(v)
        out.append(torch.empty_like(bits).index_copy_(0, index, bits).view(v.dtype))
    return out


def gather_rows(values: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """out[i] = values[src[i]], with src clipped to the rows of ``values``."""
    src = src.to(torch.int64).clamp(0, values.shape[0] - 1)
    return int32_bits(values).index_select(0, src).view(values.dtype)
