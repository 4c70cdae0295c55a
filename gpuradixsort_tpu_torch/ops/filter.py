"""Filter (selection): predicate -> mask -> one stable 1-bit counting pass.

The PyTorch counterpart of ``gpuradixsort_tpu/ops/filter.py``.  The
compaction is one binary radix pass on the negated predicate: the
histogram kernel (K1), the offsets scan (K5) and ``dest_scatter``
(``kernels/radix.py``), which ranks the digits and writes every column's
rows at their destinations, where the JAX package runs its destination
kernel and then one scatter per column; more than eight columns take a
launch per group of eight.  Selected rows land first, both groups in their
original order.

The compacted table keeps its padded buffers; the number of selected rows
stays on the device as a 0-d int32 tensor until ``Selection.to_table()``
reads it, the one host sync (the span ``<op>.sync``, named by the operator
that made the selection: ``grs.filter.sync`` here).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from gpuradixsort_tpu_torch.config import EngineConfig
from gpuradixsort_tpu_torch.core.table import Column, Table
from gpuradixsort_tpu_torch.kernels import radix as radix_kernels
from gpuradixsort_tpu_torch.utils import trace


@dataclasses.dataclass(frozen=True)
class Selection:
    """A filtered table: selected rows first, count as a 0-d device tensor."""

    table: Table
    count: torch.Tensor  # 0-d int32: number of selected rows
    op: str = "grs.filter"  # the span of the operator that made it

    def to_table(self) -> Table:
        """Read the count back to the host and return a tight Table."""
        with trace.span(f"{self.op}.sync"):
            n = int(self.count)
        return Table(
            {
                name: Column(col.data, min(n, col.length))
                for name, col in self.table.columns.items()
            }
        )


def _compact_by_mask(
    mask: torch.Tensor, values: list[torch.Tensor], cfg: EngineConfig
) -> tuple[list[torch.Tensor], torch.Tensor]:
    """Stably move the rows with mask == 1 to the front.

    mask: (padded,) integer 0/1.  Selected rows are digit 0 and dropped rows
    digit 1 of a 1-bit pass.  Returns (values moved, count of selected rows
    as a 0-d int32 tensor).
    """
    bit_cfg = EngineConfig(radix_bits=1, tile_rows=cfg.tile_rows)
    digit = (1 - mask.to(torch.int32)).view(torch.uint32)
    hist = radix_kernels.tile_histograms(digit, 0, bit_cfg)
    offsets = radix_kernels.global_offsets(hist)
    out = radix_kernels.dest_scatter(digit, hist, offsets, 0, bit_cfg, values)
    # Digit 1 starts right after every selected row.
    return out, offsets[0, 1]


def filter_table(
    table: Table,
    predicate: Callable[[Table], torch.Tensor],
    cfg: EngineConfig | None = None,
) -> Selection:
    """Keep rows where ``predicate`` is true, preserving order.

    ``predicate`` receives the table and returns a boolean or 0/1 integer
    mask over the padded row space; pad rows are masked out here.
    """
    with trace.span("grs.filter"):
        cfg = cfg or EngineConfig()
        mask = predicate(table).to(torch.int32)
        n = table.length
        padded = next(iter(table.columns.values())).padded_length
        if tuple(mask.shape) != (padded,):
            raise ValueError(
                f"predicate mask has shape {tuple(mask.shape)}, expected ({padded},)"
            )
        # Pad rows never survive the filter.
        mask = mask * (torch.arange(padded, device=mask.device) < n)
        names = table.names()
        trace.rows("compact", n, padded)
        out, count = _compact_by_mask(mask, [table[name].data for name in names], cfg)
        out_table = Table(
            {name: Column(data, table[name].length) for name, data in zip(names, out)}
        )
        return Selection(out_table, count)
