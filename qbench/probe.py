"""What a query plan reports besides its answer: spans, least bytes, operator outputs.

A plan takes one ``Probe`` a query and calls it around the program's
operators.  ``span`` times an operator call and its ``to_table()``, which
ends in a host sync, on the host clock (only when spans are on) and names
it in the profiler's trace.  ``sorted``, ``compacted`` and ``joined``
count the least bytes the operator's sorts and compactions must move,
from the live rows of the tables the plan passes and gets: a sort reads
each key once and writes the sorted key and the permutation once; a
compaction reads each row's mask byte and columns once and writes each
kept row once.  The counts follow the work, not the passes or launches
that do it.  ``keep`` copies an operator's whole output to the host, for
the one query a run whose operators the reference checks; the seconds it
takes (``kept_s``) are the benchmark's, not the query's.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
from torch.profiler import record_function

from qbench.reference.common import host

SORT_ROW_BYTES = 12  # key read, sorted key and permutation written: 4 bytes each
MASK_BYTES = 1  # a compaction's predicate, one byte a row


def host_columns(table) -> dict[str, np.ndarray]:
    """A table's live rows on the host: {column: array}, uint32 keys kept uint32."""
    return host({name: table[name].data[: table[name].length] for name in table.names()})


def row_bytes(table) -> int:
    """Bytes of one row of the table's columns."""
    return sum(table[name].data.element_size() for name in table.names())


class Probe:
    """One query's spans, byte counts and (when ``keeping``) operator outputs."""

    def __init__(self, spans: dict[str, float] | None, keeping: bool = False):
        self.spans = spans  # layer -> seconds, summed over queries; None: spans off
        self.keeping = keeping
        self.kept: dict[str, dict[str, np.ndarray]] = {}
        self.kept_s = 0.0
        self.sort_bytes = 0
        self.compact_bytes = 0

    @contextlib.contextmanager
    def span(self, layer: str):
        with record_function(f"qbench.{layer}"):
            if self.spans is None:
                yield
                return
            t = time.perf_counter()
            yield
            self.spans[layer] = self.spans.get(layer, 0.0) + time.perf_counter() - t

    def sorted(self, live: int) -> None:
        self.sort_bytes += SORT_ROW_BYTES * live

    def compacted(self, live_in: int, live_out: int, nbytes: int) -> None:
        self.compact_bytes += live_in * (MASK_BYTES + nbytes) + live_out * nbytes

    def joined(self, probe, build, out) -> None:
        """A join: the sort of the build side, then the compaction of the joined rows."""
        self.sorted(build.length)
        self.compacted(probe.length, out.length, row_bytes(out))

    def keep(self, name: str, table) -> None:
        if self.keeping:
            t = time.perf_counter()
            self.kept[name] = host_columns(table)
            self.kept_s += time.perf_counter() - t
