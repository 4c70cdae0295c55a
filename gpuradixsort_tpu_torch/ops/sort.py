"""Stable LSD radix sort over columnar buffers.

The PyTorch counterpart of ``gpuradixsort_tpu/ops/sort.py``.  Methods:

- ``"fused"``: one read of the keys for the pass plan and every pass's
  digit counts (``kernels/sort_plan.py::sort_plan``), then ``cfg.num_passes``
  passes of one kernel each, which bucketizes each partition of the keys,
  finds its run offsets by a look-back over the partitions and scatters it
  (``kernels/scatter.py::bucketize_scatter_lookback``: the JAX package's
  ``tile_histograms``, ``global_offsets``, ``bucketize_tiles`` and
  ``scatter_runs``).  Takes 1-, 2- and 4-bit digits.  As the JAX package
  jits the whole sort and decides each pass's constant-digit skip on the
  device, the plan is made on the card from the keys' AND and OR, and the
  passes read it: a skipped pass's kernel exits at once.
- ``"radix"``: ``cfg.num_passes`` passes, each one histogram kernel, the
  offsets scan and one ``dest_scatter`` launch (``kernels/radix.py``), which
  ranks each tile and writes the keys and every carried column at their
  destinations: the JAX package's ``tile_destinations`` and the scatter
  after it, with no destination buffer (the plain version runs both).
  Takes digits up to 8 bits, and has no constant-digit skip, as in the JAX
  package.
- ``"auto"``: ``"radix"`` for 8-bit digits, which the fused bucketize does
  not take, else ``"fused"``.  A stable sort has one answer, so this gives
  the JAX package's result wherever its ``"auto"`` sorts.
- ``"torch"``: the library baseline, ``torch.sort(stable=True)``, standing
  where the JAX package's ``lax.sort`` method stands.  Never the main path.

The fused and radix methods run with no host sync inside a sort, as the JAX
package jits each as one program, and on the card a shape that recurs, up
to ``GRAPH_MAX_PADDED`` padded keys, replays one cached CUDA graph
(``_graph_of``).

The fused sort takes a key column's buffer and its live length as they
are.  Its per-call inputs, the caller's keys, the index (or none, where the
sort makes it), the result R and the length, reach its kernels through an
argument block on the card, written by one launch before the passes
(``sort_plan.sort_args``), eager or graphed alike.  So its graph copies
nothing in or out and serves every live length of a padded shape, the
first pass that reads the input makes the index and reads the rows past
the length as pads, and no torch pass over the buffer re-pads the keys or
makes the index: the JAX package's ``jnp.where`` and ``jnp.arange``, which
the plain versions still run.  The pads have no vote in the plan and ride
no pass: a pass walks only the partitions that hold live rows, and the
last one that runs writes R's pad rows once.  The radix and torch methods
make the index column and re-pad with torch, as before, and walk the whole
padded buffer.

On CUDA tensors every pass runs the CUDA kernels; on CPU tensors their plain
versions.  Nothing but ``"torch"`` calls ``torch.sort``.

The JAX package falls back to a whole ``lax.sort`` when a run overflows the
TPU scatter window.  The CUDA scatter has no window, so there is no
fall-back here.
"""

from __future__ import annotations

import contextlib
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
from gpuradixsort_tpu_torch.kernels.gather import gather_columns
from gpuradixsort_tpu_torch.kernels.sort_plan import (
    ARGS_WORDS,
    SortArgs,
    lookback_rows,
    sort_args,
    sort_plan,
)
from gpuradixsort_tpu_torch.kernels.scan import exclusive_scan
from gpuradixsort_tpu_torch.kernels.scatter import bucketize_scatter_lookback
from gpuradixsort_tpu_torch.ops.permute import gather_rows
from gpuradixsort_tpu_torch.utils import trace

METHODS = ("auto", "fused", "torch", "radix")


def _fused_passes(args: SortArgs, cfg: EngineConfig, skipped: torch.Tensor,
                  block: torch.Tensor | None = None):
    """The fused sort of ``args`` with no host sync: the pass plan, then every pass as it routes.

    ``sort_plan`` reads the live keys once: it decides on the device which
    passes run, those whose digit varies over the live keys (the JAX
    package's per-pass ``lax.cond`` asks it of the padded buffer), adds the
    skipped ones to ``skipped``, counts every pass's digits and clears the
    look-back's scratch.  Each pass is one ``bucketize_scatter_lookback``
    launch over the live partitions, which in a skipped pass exits at once,
    so the pass moves no key; the last that runs writes R's pad rows.  A
    pass cannot scatter into the buffer it reads, so the passes that run
    ping-pong between the result R (``args.result``) and a scratch buffer
    S, as the plan names them: the first reads the input, which is
    never written, and the last writes R.  On the card every launch reads
    the input, the length and R from ``block``, the argument block of
    ``args`` (``sort_args``), written here where None; the plain versions
    read ``args``.  Returns R (keys, idx).
    """
    keys = args.keys
    if block is None and keys.is_cuda:  # an eager sort's
        block = sort_args(args)
    live = dict(length=args.length, block=block)
    state = sort_plan(keys, cfg, skipped, **live)
    scratch = (torch.empty_like(keys), torch.empty_like(keys))
    for p in range(cfg.num_passes):
        bucketize_scatter_lookback(keys, args.idx, cfg, state, p, (args.result, scratch), **live)
    return args.result


def _radix_pass(keys: torch.Tensor, carried: tuple, shift: int,
                cfg: EngineConfig) -> tuple[torch.Tensor, tuple]:
    """One stable counting pass on digit (keys >> shift) & (radix - 1).

    keys: (padded,) uint32; carried: tensors of the same rows, permuted
    alongside.  Returns (keys, carried) reordered by the digit, stably.
    """
    hist = radix_kernels.tile_histograms(keys, shift, cfg)
    offsets = radix_kernels.global_offsets(hist)
    out = radix_kernels.dest_scatter(keys, hist, offsets, shift, cfg, [keys, *carried])
    return out[0], tuple(out[1:])


def _radix_passes(keys: torch.Tensor, *carried: torch.Tensor, cfg: EngineConfig) -> tuple:
    """The radix method's passes, with no host sync; returns (keys, *carried)."""
    for p in range(cfg.num_passes):
        keys, carried = _radix_pass(keys, carried, p * cfg.radix_bits, cfg)
    return (keys, *carried)


# Padded lengths up to this run a sort's passes as one CUDA graph once the
# shape recurs, longer ones eagerly.  On an H100 80GB HBM3 (700 W), by CUDA
# events in chip_smoke.py's graph A/B (median of 16 in alternating rounds,
# PERF.md section 5), graphed against eager, random keys: fused, whose
# graph copies nothing, 0.1994 / 0.4709 ms at 1M keys, 0.7692 / 0.9114 at
# 2^23, 1.2885 / 1.2862 at 2^24, 2.2547 / 2.3349 at 2^25; radix, whose
# graph copies its inputs in and its outputs out, 0.4055 / 2.0400 at 1M,
# 1.0440 / 2.8833 at 2^23, 1.8746 / 3.3688 at 2^24 (its eager loop is paced
# by the host: device busy 1.5429 ms of the 3.3688).  Both graphs led or
# tied at every length.  The limit stays at 2^24 until a benchmark cell with
# recurring shapes settles the crossover.
GRAPH_MAX_PADDED = 1 << 24
# A radix graph's inputs, the keys and every carried column, hold at most
# GRAPH_MAX_PADDED rows of this many bytes (a key and its index), so that a
# radix sort carrying wide columns graphs only a shorter buffer.
_GRAPH_ROW_BYTES = 8
# Graphs kept at most, of both methods.  None is dropped to make room: once
# the cache is full, shapes not in it run eagerly until clear_sort_graphs(),
# so traffic over more recurring shapes than this captures no more than
# this many times.  A graph holds its intermediates and, for the radix
# method, its inputs and outputs: on an H100, in chip_smoke.py phase 5, 278
# MiB for a radix graph carrying the index at 2^24, about 2.2 times its
# inputs' bytes, so the byte limit above holds the cache to about 2.2 GiB;
# a radix graph carrying wider rows than the index has not been measured.
# A fused graph holds the scratch S and the plan's state: 130 MiB at 2^24
# keys, about 8 bytes a padded key (chip_smoke.py's graph A/B).
GRAPH_CACHE_ENTRIES = 8
# Shapes seen once and remembered, so that a second sighting captures; the
# least recently seen is forgotten first.
_SEEN_ENTRIES = 1024
# The wrappers the sorts call inside a graph: a replay adds its capture's
# launches to them.  sort_args runs outside the graph and counts itself.
_PASS_WRAPPERS = (radix_kernels.tile_histograms, bucketize_scatter_lookback, exclusive_scan,
                  sort_plan, radix_kernels.dest_scatter)


class _SortGraph:
    """One sort method's passes on one shape as one CUDA graph.

    Captured once on a side stream, its intermediates in the graph's private
    memory pool.  Holds the launches each wrapper made during the capture,
    which every replay adds to the wrappers' counts, and an event after the
    last call, so that calls on different streams take turns.
    """

    def __init__(self, device: torch.device):
        self.device = device
        self.graph = torch.cuda.CUDAGraph()
        self.done = torch.cuda.Event()
        self.replays = 0

    def _capture(self, run, *inputs):
        """Capture ``run(*inputs)``; returns its output, which lies in the graph's pool."""
        # The shape's first sighting ran eagerly: that is the warm-up
        # PyTorch asks for before a capture, as every kernel has launched.
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        before = [w.launches for w in _PASS_WRAPPERS]
        try:
            # capture_begin/end rather than torch.cuda.graph(), which first
            # synchronizes, collects garbage and empties the allocator's cache.
            with torch.cuda.stream(side):
                self.graph.capture_begin()
                try:
                    out = run(*inputs)
                finally:
                    self.graph.capture_end()
            self.launches = [w.launches - n for w, n in zip(_PASS_WRAPPERS, before)]
        finally:
            for w, n in zip(_PASS_WRAPPERS, before):
                w.launches = n  # a capture runs nothing
        torch.cuda.current_stream(self.device).wait_stream(side)
        return out

    @contextlib.contextmanager
    def _turn(self):
        """The body replays on the current stream once the last call, on any stream, is done."""
        stream = torch.cuda.current_stream(self.device)
        stream.wait_event(self.done)
        yield
        self.done.record(stream)
        self.replays += 1
        for w, n in zip(_PASS_WRAPPERS, self.launches):
            w.launches += n


class _RadixGraph(_SortGraph):
    """The radix method's graph: captured on static copies of its inputs, which each call
    copies in, and its outputs cloned out."""

    def __init__(self, run, inputs: tuple):
        super().__init__(inputs[0].device)
        self.inputs = tuple(t.clone() for t in inputs)
        self.out = tuple(self._capture(run, *self.inputs))

    def __call__(self, *inputs: torch.Tensor) -> tuple:
        with self._turn():
            for static, t in zip(self.inputs, inputs):
                static.copy_(t)
            self.graph.replay()
            out = tuple(t.clone() for t in self.out)
        return out


class _FusedGraph(_SortGraph):
    """The fused sort's graph: its kernels read the call's input, length and R from a
    static argument block, which each call writes before the replay; nothing is copied."""

    def __init__(self, args: SortArgs, cfg: EngineConfig, skipped: torch.Tensor):
        super().__init__(args.keys.device)
        self.block = torch.empty(ARGS_WORDS, dtype=torch.int64, device=self.device)
        self._capture(functools.partial(_fused_passes, cfg=cfg, skipped=skipped,
                                        block=self.block), args)

    def __call__(self, args: SortArgs) -> tuple:
        with self._turn():
            sort_args(args, self.block)
            self.graph.replay()
        return args.result


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
    ``num_carried``.  The fused method's graph carries no column (it reads
    an index, or makes one, through its argument block), so its key has
    none.  Nothing that depends on the keys' values, or on the live length,
    enters it.
    """
    keys, *carried = inputs
    if method == "fused":
        carried = ()
    return (keys.device, keys.numel(), cfg, method,
            tuple((c.dtype, tuple(c.shape[1:])) for c in carried))


def _graph_of(method: str, inputs: tuple, cfg: EngineConfig, make):
    """The cached graph of a CUDA sort, ``make()`` captured at its shape's second sighting.

    On a CUDA buffer of at most ``GRAPH_MAX_PADDED`` keys, whose inputs
    hold at most ``GRAPH_MAX_PADDED * _GRAPH_ROW_BYTES`` bytes, the first
    call of a ``graph_key`` runs eagerly (None); the next one captures a
    graph, if the cache has room, and every later one replays it.  Longer
    or wider buffers and CPU tensors run eagerly.  A failed capture raises;
    nothing falls back.
    """
    keys = inputs[0]
    if (not keys.is_cuda or keys.numel() > GRAPH_MAX_PADDED
            or sum(t.nbytes for t in inputs) > GRAPH_MAX_PADDED * _GRAPH_ROW_BYTES):
        return None
    key = graph_key(method, inputs, cfg)
    graph = _SORT_GRAPHS.get(key)
    if graph is None:
        if key not in _SEEN or len(_SORT_GRAPHS) >= GRAPH_CACHE_ENTRIES:
            _SEEN[key] = None
            _SEEN.move_to_end(key)
            if len(_SEEN) > _SEEN_ENTRIES:
                _SEEN.popitem(last=False)
            return None
        with torch.cuda.device(keys.device):
            graph = make()
        trace.graph_captured()
        _SORT_GRAPHS[key] = graph
        del _SEEN[key]
    return graph


# Passes the fused sorts skipped: one int64 counter on each device, to which
# the plan kernel adds, read only by skipped_passes().
_SKIPPED: dict = {}


def _skip_counter(device: torch.device) -> torch.Tensor:
    if device not in _SKIPPED:
        _SKIPPED[device] = torch.zeros(1, dtype=torch.int64, device=device)
    return _SKIPPED[device]


def skipped_passes() -> int:
    """Passes every fused sort so far skipped, on every device: constant digits.

    Reads the counters back, a host sync (the span ``grs.sort.sync``): call
    it after the sorts, not between them.
    """
    with trace.span("grs.sort.sync"):
        return sum(int(c.item()) for c in _SKIPPED.values())


def _fused_sort(keys: torch.Tensor, idx: torch.Tensor | None, length: int,
                cfg: EngineConfig) -> tuple:
    """The fused sort of a padded buffer's ``length`` live keys; returns R (keys, idx), new buffers.

    ``idx``: the index the keys carry, or None, where the first pass that
    reads the input makes it (element e's index e).  The input's rows from
    ``length`` on sort as (PAD_KEY, PAD_INDEX), whatever they hold.  One
    program on the card, as the JAX package's jit makes it: the argument
    block (``sort_args``), then the pass plan and the passes with no host
    sync (``_fused_passes``), eagerly or by replaying the shape's cached
    graph (``_graph_of``), whose key holds no length.
    """
    radix_kernels.check_keys("keys", keys, cfg)
    if idx is not None:
        radix_kernels.check_keys("idx", idx, cfg)
        if idx.numel() != keys.numel() or idx.device != keys.device:
            raise ValueError("keys and idx must have one length and one device")
    args = SortArgs(keys, idx, (torch.empty_like(keys), torch.empty_like(keys)), length)
    skipped = _skip_counter(keys.device)
    graph = _graph_of("fused", (keys,), cfg, lambda: _FusedGraph(args, cfg, skipped))
    return _fused_passes(args, cfg, skipped) if graph is None else graph(args)


def _fused_sort_padded(keys: torch.Tensor, idx: torch.Tensor, cfg: EngineConfig):
    """Stable (key, index) sort of padded 1-D uint32 buffers, every row live.

    The counterpart of the JAX package's ``_fused_sort_padded``: the given
    index is read through the sort's argument block (``_fused_sort``).
    Returns new buffers (keys, idx, overflow); overflow is always False (no
    window).
    """
    keys, idx = _fused_sort(keys, idx, keys.numel(), cfg)
    return keys, idx, False


def _fused_sort_live(keys: torch.Tensor, length: int, cfg: EngineConfig) -> tuple:
    """The fused sort of a key column's padded buffer and live length, its index made on the card.

    The rows from ``length`` on sort as pads whatever they hold, and the
    index is 0..length-1 then PAD_INDEX, as the JAX package builds them with
    ``jnp.where``, ``jnp.arange`` and ``pad_to_tile``; on the card no torch
    pass over the buffer does.  Returns (sorted keys, permutation).
    """
    return _fused_sort(keys, None, length, cfg)


def _sort_padded(keys: torch.Tensor, carried: tuple,
                 cfg: EngineConfig) -> tuple[torch.Tensor, tuple]:
    """The radix method: stable sort of padded keys, carrying other columns.

    Its passes run with no host sync, by a cached graph where a CUDA shape
    recurs (``_graph_of``), as the JAX package jits them keyed on ``cfg``
    and ``num_carried``.  The JAX package's ``strategy`` picks how a TPU
    applies the permutation; it means nothing on the GPU, so the port takes
    none.
    """
    inputs = (keys, *carried)
    run = functools.partial(_radix_passes, cfg=cfg)
    graph = _graph_of("radix", inputs, cfg, lambda: _RadixGraph(run, inputs))
    keys, *carried = run(*inputs) if graph is None else graph(*inputs)
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
    """0..length-1 as uint32, then PAD_INDEX over the pad rows (the radix and torch methods)."""
    pos = torch.arange(col.padded_length, dtype=torch.int32, device=col.device)
    return torch.where(pos < col.length, pos, uint32_as_int32(PAD_INDEX)).view(torch.uint32)


def _sort_column(col: Column, cfg: EngineConfig, method: str):
    """(sorted keys, permutation) of a key column by one method.

    The fused sort takes the buffer and its length as they are; the radix
    and torch methods sort the re-padded buffer (``_repadded``) with the
    index column.  Counts the sort's live rows and the rows its passes walk
    (``trace.rows``): the fused sort's live partitions, the others' whole
    buffer.
    """
    fused = method == "fused"
    trace.rows("sort", col.length,
               lookback_rows(col.length, col.padded_length) if fused else col.padded_length)
    if fused:
        return _fused_sort_live(col.data, col.length, cfg)
    col = _repadded(col)
    idx = _index_column(col)
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
    with trace.span("grs.sort"):
        cfg = cfg or EngineConfig()
        method = _resolve_method(method, cfg)
        col = _key_column(keys, cfg, device)
        if method == "radix":  # no index column to carry
            trace.rows("sort", col.length, col.padded_length)
            sorted_keys, _ = _sort_padded(_repadded(col).data, (), cfg)
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
    with trace.span("grs.sort"):
        return _sort_pairs(keys, cfg or EngineConfig(), method, device)


def _sort_pairs(keys, cfg: EngineConfig, method: str, device=None) -> tuple[Column, Column]:
    """``sort_pairs`` inside its caller's span."""
    method = _resolve_method(method, cfg)
    col = _key_column(keys, cfg, device)
    sorted_keys, perm = _sort_column(col, cfg, method)
    return Column(sorted_keys, col.length), Column(perm, col.length)


def sort_table(
    table: Table, key: str, cfg: EngineConfig | None = None, method: str = "auto",
) -> Table:
    """Sort a whole table by one uint32 key column, stably.

    Sorts (key, index) pairs, then gathers every payload column through the
    sorted index, all in one ``gather_columns``.  As in the JAX package, the
    index is read as int32, so a pad row's PAD_INDEX becomes -1 and is
    clipped to row 0.  Every method's pad rows lie past ``length`` and are
    PAD_INDEX, so the gather reads the index only below ``length`` and
    writes the rows past it from row 0.
    """
    with trace.span("grs.sort"):
        sorted_keys, perm = _sort_pairs(table[key], cfg or EngineConfig(), method)
        payloads = [name for name in table.names() if name != key]
        out = {key: sorted_keys}
        if payloads:
            trace.rows("gather", perm.length, perm.padded_length)
            trace.gather_filled(perm.padded_length - perm.length)
            cols = [table[name] for name in payloads]
            gathered = gather_columns([c.data for c in cols], int32_bits(perm.data), perm.length)
            out.update((name, Column(g, c.length)) for name, c, g in zip(payloads, cols, gathered))
        return Table(out)


def _key_column(keys, cfg: EngineConfig, device=None) -> Column:
    """The padded key column a sort starts from, its rows past the length as they lie.

    2^31 padded rows or more raise.
    """
    if not isinstance(keys, Column):
        return make_key_column(keys, cfg, device=device)
    if keys.dtype != torch.uint32 or keys.data.dim() != 1:
        raise ValueError(f"key column must be 1-D torch.uint32, got {keys.dtype}")
    check_padded_rows(keys.padded_length, cfg.tile)
    return keys


def _repadded(col: Column) -> Column:
    """``col`` with PAD_KEY re-asserted past its length, so that stale rows sort to the back."""
    if col.length == col.padded_length:
        return col
    pos = torch.arange(col.padded_length, device=col.device)
    data = torch.where(pos < col.length, int32_bits(col.data), uint32_as_int32(PAD_KEY))
    return Column(data.view(torch.uint32), col.length)
