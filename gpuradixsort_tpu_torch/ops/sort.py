"""Stable LSD radix sort over columnar buffers.

The PyTorch counterpart of ``gpuradixsort_tpu/ops/sort.py``.  Methods:

- ``"fused"``: ``cfg.num_passes`` passes, each one histogram kernel, the
  offsets scan, one bucketize kernel and one scatter kernel.  Takes 1-, 2-
  and 4-bit digits.  As the JAX package jits the whole sort and decides each
  pass's constant-digit skip on the device, the port reads back once which
  digits vary and then runs the passes without a host sync; on the card, a
  shape that recurs, up to ``GRAPH_MAX_PADDED`` keys, as one cached CUDA
  graph.
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

from collections import OrderedDict

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
from gpuradixsort_tpu_torch.kernels.key_bits import key_bits
from gpuradixsort_tpu_torch.kernels.scan import exclusive_scan
from gpuradixsort_tpu_torch.kernels.scatter import scatter_runs
from gpuradixsort_tpu_torch.ops.permute import gather_rows, scatter_by_destination

METHODS = ("auto", "fused", "torch", "radix")


def _pass_mask(keys: torch.Tensor, cfg: EngineConfig) -> int:
    """Bit p set where pass p runs: where digit p varies over the padded buffer.

    The JAX package skips pass p when the pass's histogram has one non-empty
    bucket, pad keys included.  A pass keeps the multiset of the keys, so
    that holds before the first pass exactly where digit p's bits agree in
    the AND and the OR of every key (``key_bits``).  Reading those 8 bytes
    back is the fused sort's one host sync.
    """
    all_bits, any_bits = (w & 0xFFFFFFFF for w in int32_bits(key_bits(keys)).tolist())
    varying = any_bits & ~all_bits  # 0 for an empty buffer, as no bucket is filled
    return sum(1 << p for p in range(cfg.num_passes)
               if (varying >> (p * cfg.radix_bits)) & (cfg.radix - 1))


def _fused_passes(keys: torch.Tensor, idx: torch.Tensor, mask: int, cfg: EngineConfig):
    """The passes of ``mask``, one after another, with no host sync: the eager loop.

    Each pass: histogram -> offsets -> bucketize -> scatter.  The skip is
    decided on the host, not by a flag on the card read by K2 and K3: a
    skipped pass must hand back its input, so K3 would still copy its 16
    bytes a key.  Returns (keys, idx).
    """
    for p in range(cfg.num_passes):
        if (mask >> p) & 1:
            shift = p * cfg.radix_bits
            hist = radix_kernels.tile_histograms(keys, shift, cfg)
            offsets = radix_kernels.global_offsets(hist)
            bk, bi = bucketize_tiles(keys, idx, shift, cfg)
            keys, idx, _ = scatter_runs(bk, bi, hist, offsets, cfg)
    return keys, idx


# Padded lengths up to this run the fused sort's passes as one CUDA graph
# once the shape recurs, longer ones by the eager loop.  On an H100 (700 W),
# by CUDA events in chip_smoke.py phase 5, the graph with its copies in and
# out against the eager loop: 0.570 / 1.661 ms at 1M keys, 0.853 / 2.345 at
# 2^22, 1.470 / 1.906 at 2^23, 2.705 / 3.093 at 2^24, and 4.995 / 4.804 at
# 2^25, where the copies (32 bytes a key) cost more than the host time the
# eager loop hides behind the card.
GRAPH_MAX_PADDED = 1 << 24
# Graphs kept at most.  None is dropped to make room: once the cache is
# full, shapes not in it run the eager loop until clear_sort_graphs(), so
# traffic over more recurring shapes than this captures no more than this
# many times.  A graph holds about 32 bytes a padded key (536 MiB at 2^24),
# so the cache at most 4.2 GiB; chip_smoke.py's operator timings recur on
# 3 shapes, whose graphs hold 1.2 GiB.
GRAPH_CACHE_ENTRIES = 8
# Shapes seen once and remembered, so that a second sighting captures; the
# least recently seen is forgotten first.
_SEEN_ENTRIES = 1024
# The wrappers the passes call: a replay adds its capture's launches to them.
_PASS_WRAPPERS = (radix_kernels.tile_histograms, bucketize_tiles, scatter_runs, exclusive_scan)


class _SortGraph:
    """The passes of one (device, padded length, cfg, mask) as one CUDA graph.

    Holds static input buffers, the outputs of the capture in the graph's
    private memory pool (with every intermediate of the passes), the
    launches each wrapper made during the capture, and an event after the
    last call's copies out, so that calls on different streams take turns.
    """

    def __init__(self, keys: torch.Tensor, idx: torch.Tensor, mask: int, cfg: EngineConfig):
        # The shape's first sighting ran the eager loop: that is the warm-up
        # PyTorch asks for before a capture, as every kernel has launched.
        dev = keys.device
        self.keys, self.idx = keys.clone(), idx.clone()
        self.graph = torch.cuda.CUDAGraph()
        self.done = torch.cuda.Event()
        self.replays = 0
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        before = [w.launches for w in _PASS_WRAPPERS]
        try:
            # capture_begin/end rather than torch.cuda.graph(), which first
            # synchronizes, collects garbage and empties the allocator's cache.
            with torch.cuda.stream(side):
                self.graph.capture_begin()
                try:
                    self.out = _fused_passes(self.keys, self.idx, mask, cfg)
                finally:
                    self.graph.capture_end()
            self.launches = [w.launches - n for w, n in zip(_PASS_WRAPPERS, before)]
        finally:
            for w, n in zip(_PASS_WRAPPERS, before):
                w.launches = n  # a capture runs nothing
        torch.cuda.current_stream(dev).wait_stream(side)

    def __call__(self, keys: torch.Tensor, idx: torch.Tensor):
        """Copy the inputs in, replay, and return copies of the outputs."""
        stream = torch.cuda.current_stream(self.keys.device)
        stream.wait_event(self.done)  # the last call, on any stream, has copied out
        self.keys.copy_(keys)
        self.idx.copy_(idx)
        self.graph.replay()
        out = self.out[0].clone(), self.out[1].clone()
        self.done.record(stream)
        self.replays += 1
        for w, n in zip(_PASS_WRAPPERS, self.launches):
            w.launches += n
        return out


_SORT_GRAPHS: dict = {}
_SEEN: OrderedDict = OrderedDict()


def clear_sort_graphs() -> None:
    """Drop every cached sort graph, its buffers and memory pool, and every shape seen.

    ``torch.cuda.empty_cache()`` afterwards hands the pools back to the card.
    """
    for dev in {key[0] for key in _SORT_GRAPHS}:
        torch.cuda.synchronize(dev)  # no replay in flight
    _SORT_GRAPHS.clear()
    _SEEN.clear()


def _graphed_passes(keys: torch.Tensor, idx: torch.Tensor, mask: int, cfg: EngineConfig):
    """The passes of ``mask`` on a CUDA buffer, by a cached graph where the shape recurs.

    The first call of a (device, padded length, cfg, mask) runs the eager
    loop; the next one captures a graph, if the cache has room, and every
    later one replays it.  A failed capture raises; nothing falls back to
    the eager loop.
    """
    key = (keys.device, keys.numel(), cfg, mask)
    graph = _SORT_GRAPHS.get(key)
    if graph is None:
        if key not in _SEEN or len(_SORT_GRAPHS) >= GRAPH_CACHE_ENTRIES:
            _SEEN[key] = None
            _SEEN.move_to_end(key)
            if len(_SEEN) > _SEEN_ENTRIES:
                _SEEN.popitem(last=False)
            return _fused_passes(keys, idx, mask, cfg)
        with torch.cuda.device(keys.device):
            graph = _SortGraph(keys, idx, mask, cfg)
        _SORT_GRAPHS[key] = graph
        del _SEEN[key]
    return graph(keys, idx)


def _fused_sort_padded(keys: torch.Tensor, idx: torch.Tensor, cfg: EngineConfig):
    """Stable (key, index) sort of padded 1-D uint32 buffers.

    One readback decides which passes run (``_pass_mask``); they then run
    with no host sync: on a CUDA buffer of at most ``GRAPH_MAX_PADDED`` keys
    by ``_graphed_passes``, else by the eager loop.  Returns (keys, idx,
    overflow); overflow is always False (no window).  Adds the number of
    skipped passes to ``_fused_sort_padded.skipped_passes``.
    """
    radix_kernels.check_keys("keys", keys, cfg)
    radix_kernels.check_keys("idx", idx, cfg)
    if idx.numel() != keys.numel() or idx.device != keys.device:
        raise ValueError("keys and idx must have one length and one device")
    mask = _pass_mask(keys, cfg)
    _fused_sort_padded.skipped_passes += cfg.num_passes - bin(mask).count("1")
    if mask and keys.is_cuda and keys.numel() <= GRAPH_MAX_PADDED:
        keys, idx = _graphed_passes(keys, idx, mask, cfg)
    else:
        keys, idx = _fused_passes(keys, idx, mask, cfg)
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

    ``torch.sort`` takes no uint32 on CUDA, so it sorts the int32 view with
    the sign bit flipped, whose order is the keys' unsigned order, at 4 bytes
    a key; flipped back, its values are the sorted keys, and the indices
    follow through its order.
    """
    sign = torch.iinfo(torch.int32).min
    values, order = torch.sort(int32_bits(keys) ^ sign, stable=True)
    return (values ^ sign).view(keys.dtype), gather_rows(idx, order)


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
