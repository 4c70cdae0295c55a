"""Stable LSD radix sort over columnar buffers.

The PyTorch counterpart of ``gpuradixsort_tpu/ops/sort.py``.  Methods:

- ``"fused"``: one read of the keys for the pass plan and every pass's
  digit counts (``kernels/key_bits.py::sort_plan``), then ``cfg.num_passes``
  passes of one kernel each, which bucketizes each partition of the keys,
  finds its run offsets by a look-back over the partitions and scatters it
  (``kernels/scatter.py::bucketize_scatter_lookback``: the JAX package's
  ``tile_histograms``, ``global_offsets``, ``bucketize_tiles`` and
  ``scatter_runs``).  Takes 1-, 2- and 4-bit digits.  As the JAX package
  jits the whole sort and decides each pass's constant-digit skip on the
  device, the plan is made on the card from the keys' AND and OR, and the
  passes read it: a skipped pass's kernel exits at once.
- ``"radix"``: ``cfg.num_passes`` passes, each one histogram kernel, the
  offsets scan, one destination kernel and one indexed store per column
  (``permute.scatter_by_destination``).  Takes digits up to 8 bits, and has
  no constant-digit skip, as in the JAX package.
- ``"auto"``: ``"radix"`` for 8-bit digits, which the fused bucketize does
  not take, else ``"fused"``.  A stable sort has one answer, so this gives
  the JAX package's result wherever its ``"auto"`` sorts.
- ``"torch"``: the library baseline, ``torch.sort(stable=True)``, standing
  where the JAX package's ``lax.sort`` method stands.  Never the main path.

The fused and radix methods run with no host sync inside a sort, as the JAX
package jits each as one program, and on the card a shape that recurs, up
to ``GRAPH_MAX_PADDED`` padded keys, replays one cached CUDA graph
(``_dispatch``).

On CUDA tensors every pass runs the CUDA kernels; on CPU tensors their plain
versions.  Nothing but ``"torch"`` calls ``torch.sort``.

The JAX package falls back to a whole ``lax.sort`` when a run overflows the
TPU scatter window.  The CUDA scatter has no window, so there is no
fall-back here.
"""

from __future__ import annotations

import functools
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
from gpuradixsort_tpu_torch.kernels.key_bits import sort_plan
from gpuradixsort_tpu_torch.kernels.scan import exclusive_scan
from gpuradixsort_tpu_torch.kernels.scatter import bucketize_scatter_lookback
from gpuradixsort_tpu_torch.ops.permute import gather_rows, scatter_by_destination

METHODS = ("auto", "fused", "torch", "radix")


def _fused_passes(keys: torch.Tensor, idx: torch.Tensor, cfg: EngineConfig,
                  skipped: torch.Tensor):
    """The fused sort with no host sync: the pass plan, then every pass as it routes.

    ``sort_plan`` reads the keys once: it decides on the device which passes
    run, as the JAX package's per-pass ``lax.cond`` does, adds the skipped
    ones to ``skipped``, counts every pass's digits and clears the
    look-back's scratch.  Each pass is one ``bucketize_scatter_lookback``
    launch, which in a skipped pass exits at once, so the pass moves no
    key.  A pass cannot scatter into the buffer it reads, so the passes
    that run ping-pong between the result buffer R and a scratch buffer S,
    as the plan names: the first reads ``keys`` and ``idx``, which are
    never written, and the last writes R.  Returns R (keys, idx).
    """
    state = sort_plan(keys, cfg, skipped)
    buffers = tuple((torch.empty_like(keys), torch.empty_like(idx)) for _ in range(2))
    for p in range(cfg.num_passes):
        bucketize_scatter_lookback(keys, idx, cfg, state, p, buffers)
    return buffers[0]


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


def _radix_passes(keys: torch.Tensor, *carried: torch.Tensor, cfg: EngineConfig) -> tuple:
    """The radix method's passes, with no host sync; returns (keys, *carried)."""
    for p in range(cfg.num_passes):
        keys, carried = _radix_pass(keys, carried, p * cfg.radix_bits, cfg)
    return (keys, *carried)


# Padded lengths up to this run a sort's passes as one CUDA graph once the
# shape recurs, longer ones eagerly.  On an H100 (700 W), by CUDA events in
# chip_smoke.py phase 5 (four rounds, PERF.md section 5), the graph with its
# copies in and out against the eager passes, random keys: fused 0.36-0.51
# / 1.53-2.80 ms at 1M keys, 1.34-1.56 / 1.78-3.39 at 2^23, 1.95-2.02 /
# 1.88-2.27 at 12M, 2.54-2.57 / 2.40-2.57 at 2^24, 4.84-5.03 / 4.56-4.83 at
# 2^25; radix 0.64-0.78 / 2.46-4.10 at 1M, 4.35-4.66 / 4.56-4.88 at 12M,
# 6.01-6.13 / 5.78-6.21 at 2^24.  With no host sync in a sort, the eager
# passes hide their host time behind the card from about 12M keys on, where
# the graph's copies (32 bytes a key) cost about what the graph saves: at
# 2^24 the eager passes won 3 of 4 rounds by each method, by at most 0.16
# ms (fused, 6 percent) and 0.26 (radix, 4 percent).  The data alone would
# put the limit near 12M.  It stays at 2^24 on purpose until a benchmark
# cell with recurring shapes settles the crossover.
GRAPH_MAX_PADDED = 1 << 24
# A graph's inputs, the keys and every carried column, hold at most
# GRAPH_MAX_PADDED rows of this many bytes (a key and its index), so that a
# radix sort carrying wide columns graphs only a shorter buffer.
_GRAPH_ROW_BYTES = 8
# Graphs kept at most, of both methods.  None is dropped to make room: once
# the cache is full, shapes not in it run eagerly until clear_sort_graphs(),
# so traffic over more recurring shapes than this captures no more than
# this many times.  A graph holds its inputs, outputs and intermediates:
# on an H100, in chip_smoke.py phase 5, 408 MiB for a fused graph at 2^24
# (about 25 bytes a padded key: the static input, the result R and the
# scratch S) and 598 MiB for a radix graph carrying the index, about 3.2
# and 4.7 times their inputs' bytes.  At the larger ratio the byte limit
# above holds the cache to about 4.7 GiB; a radix graph carrying wider rows
# than the index has not been measured.
GRAPH_CACHE_ENTRIES = 8
# Shapes seen once and remembered, so that a second sighting captures; the
# least recently seen is forgotten first.
_SEEN_ENTRIES = 1024
# The wrappers the sorts call: a replay adds its capture's launches to them.
_PASS_WRAPPERS = (radix_kernels.tile_histograms, bucketize_scatter_lookback, exclusive_scan,
                  sort_plan, radix_kernels.tile_destinations)


class _SortGraph:
    """One sort method's passes on one shape as one CUDA graph.

    ``run(*inputs)`` is captured once on static copies of the inputs, its
    outputs and every intermediate in the graph's private memory pool.
    Holds the launches each wrapper made during the capture, and an event
    after the last call's copies out, so that calls on different streams
    take turns.
    """

    def __init__(self, run, inputs: tuple):
        # The shape's first sighting ran eagerly: that is the warm-up
        # PyTorch asks for before a capture, as every kernel has launched.
        dev = inputs[0].device
        self.inputs = tuple(t.clone() for t in inputs)
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
                    self.out = tuple(run(*self.inputs))
                finally:
                    self.graph.capture_end()
            self.launches = [w.launches - n for w, n in zip(_PASS_WRAPPERS, before)]
        finally:
            for w, n in zip(_PASS_WRAPPERS, before):
                w.launches = n  # a capture runs nothing
        torch.cuda.current_stream(dev).wait_stream(side)

    def __call__(self, *inputs: torch.Tensor) -> tuple:
        """Copy the inputs in, replay, and return copies of the outputs."""
        stream = torch.cuda.current_stream(self.inputs[0].device)
        stream.wait_event(self.done)  # the last call, on any stream, has copied out
        for static, t in zip(self.inputs, inputs):
            static.copy_(t)
        self.graph.replay()
        out = tuple(t.clone() for t in self.out)
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


def graph_key(method: str, inputs: tuple, cfg: EngineConfig) -> tuple:
    """A sort's key in the graph cache: (device, padded length, cfg, method, carried).

    ``inputs``: the keys, then the columns carried with them, whose dtypes
    and row shapes stand where the JAX package's jit keys on
    ``num_carried``.  Nothing that depends on the keys' values enters it.
    """
    keys, *carried = inputs
    return (keys.device, keys.numel(), cfg, method,
            tuple((c.dtype, tuple(c.shape[1:])) for c in carried))


def _dispatch(method: str, run, inputs: tuple, cfg: EngineConfig) -> tuple:
    """``run(*inputs)``, by a cached CUDA graph where a CUDA shape recurs.

    On a CUDA buffer of at most ``GRAPH_MAX_PADDED`` keys, whose inputs
    hold at most ``GRAPH_MAX_PADDED * _GRAPH_ROW_BYTES`` bytes, the first
    call of a ``graph_key`` runs eagerly; the next one captures a graph, if
    the cache has room, and every later one replays it.  Longer or wider
    buffers and CPU tensors run eagerly.  A failed capture raises; nothing
    falls back.
    """
    keys = inputs[0]
    if (not keys.is_cuda or keys.numel() > GRAPH_MAX_PADDED
            or sum(t.nbytes for t in inputs) > GRAPH_MAX_PADDED * _GRAPH_ROW_BYTES):
        return run(*inputs)
    key = graph_key(method, inputs, cfg)
    graph = _SORT_GRAPHS.get(key)
    if graph is None:
        if key not in _SEEN or len(_SORT_GRAPHS) >= GRAPH_CACHE_ENTRIES:
            _SEEN[key] = None
            _SEEN.move_to_end(key)
            if len(_SEEN) > _SEEN_ENTRIES:
                _SEEN.popitem(last=False)
            return run(*inputs)
        with torch.cuda.device(keys.device):
            graph = _SortGraph(run, inputs)
        _SORT_GRAPHS[key] = graph
        del _SEEN[key]
    return graph(*inputs)


# Passes the fused sorts skipped: one int64 counter on each device, to which
# the plan kernel adds, read only by skipped_passes().
_SKIPPED: dict = {}


def _skip_counter(device: torch.device) -> torch.Tensor:
    if device not in _SKIPPED:
        _SKIPPED[device] = torch.zeros(1, dtype=torch.int64, device=device)
    return _SKIPPED[device]


def skipped_passes() -> int:
    """Passes every fused sort so far skipped, on every device: constant digits.

    Reads the counters back, a host sync: call it after the sorts, not
    between them.
    """
    return sum(int(c.item()) for c in _SKIPPED.values())


def _fused_sort_padded(keys: torch.Tensor, idx: torch.Tensor, cfg: EngineConfig):
    """Stable (key, index) sort of padded 1-D uint32 buffers.

    One program on the card, as the JAX package's jit makes it: the pass
    plan and the passes, with no host sync (``_fused_passes``), by a cached
    graph where a CUDA shape recurs (``_dispatch``).  Returns new buffers
    (keys, idx, overflow); overflow is always False (no window).
    """
    radix_kernels.check_keys("keys", keys, cfg)
    radix_kernels.check_keys("idx", idx, cfg)
    if idx.numel() != keys.numel() or idx.device != keys.device:
        raise ValueError("keys and idx must have one length and one device")
    run = functools.partial(_fused_passes, cfg=cfg, skipped=_skip_counter(keys.device))
    keys, idx = _dispatch("fused", run, (keys, idx), cfg)
    return keys, idx, False


def _sort_padded(keys: torch.Tensor, carried: tuple,
                 cfg: EngineConfig) -> tuple[torch.Tensor, tuple]:
    """The radix method: stable sort of padded keys, carrying other columns.

    Its passes run with no host sync, by a cached graph where a CUDA shape
    recurs (``_dispatch``), as the JAX package jits them keyed on ``cfg``
    and ``num_carried``.  The JAX package's ``strategy`` picks how a TPU
    applies the permutation; it means nothing on the GPU, so the port takes
    none.
    """
    keys, *carried = _dispatch("radix", functools.partial(_radix_passes, cfg=cfg),
                               (keys, *carried), cfg)
    return keys, tuple(carried)


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
