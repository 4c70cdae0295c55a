"""The port's spans and counters (``gpuradixsort_tpu_torch/utils/trace.py``) and their readers.

On the CPU: each operator's spans and their nesting under
``torch.profiler``, the shared no-op context with the profiler off, the
row counters on hand-sized tables, TPC-H Q18 and Q3 at a tiny scale (their
sync spans, and the sort site against the benchmark's own count of sorted
bytes), and the benchmark's four readers of them on hand-built traces.  On
a card (``cuda``): every host sync the port makes in a query lies inside a
sync span.  The file imports no JAX:

    python -m pytest --noconftest tests/test_torch_trace.py -q
"""

import collections
import json
import sys
import traceback
import warnings

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

import gpuradixsort_tpu_torch.utils
from gpuradixsort_tpu_torch.core.table import Column, Table, make_column, make_key_column
from gpuradixsort_tpu_torch.kernels import probe as probe_kernels
from gpuradixsort_tpu_torch.ops import sort as tsort
from gpuradixsort_tpu_torch.ops.aggregate import aggregate_sorted_flat, group_by_aggregate
from gpuradixsort_tpu_torch.ops.filter import filter_table
from gpuradixsort_tpu_torch.ops.join import join, join_expand
from gpuradixsort_tpu_torch.parallel import launch
from gpuradixsort_tpu_torch.utils import trace
from qbench import devicetime
from qbench.gen import tpch
from qbench.metrics import host_syncs, launch_idle_ms, live_row_share, sync_idle_ms
from qbench.outcome import RunRecord
from qbench.probe import SORT_ROW_BYTES, Probe
from qbench.queries import q3, q18
from qbench.runners.one_card import load

torch.set_num_threads(1)

TINY_SF = 0.01  # qbench/tests/conftest.py's
SEED = 2**31 + 17
PLANS = {"q18": (q18, {"quantity": 240}, 4), "q3": (q3, {"segment": 1, "date": 9200}, 6)}
SPAN_READERS = (host_syncs, sync_idle_ms, launch_idle_ms)


def _spans(prof, tmp_path) -> collections.Counter:
    """(span, innermost span holding it) of every annotation in a profile, counted."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [(e["name"], e["ts"], e["ts"] + e.get("dur", 0))
              for e in json.loads(path.read_text())["traceEvents"]
              if e.get("cat") == "user_annotation" and e.get("ph") == "X"]
    out = collections.Counter()
    for name, s, e in events:
        holders = [(pe - ps, pn) for pn, ps, pe in events
                   if ps <= s and e <= pe and pe - ps > e - s]
        out[name, min(holders)[1] if holders else None] += 1
    return out


def _profiled(fn, tmp_path) -> collections.Counter:
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return _spans(prof, tmp_path)


def _keys(values) -> Column:
    return make_key_column(np.asarray(values, dtype=np.uint32), device="cpu")


def _table(n: int, seed: int = 0) -> Table:
    """``n`` rows of keys with duplicates and an int32 column."""
    rng = np.random.default_rng(seed)
    return Table({"k": _keys(rng.integers(0, n // 2 + 1, n)),
                  "v": make_column(rng.integers(0, 100, n).astype(np.int32), device="cpu")})


def _unique_build(n: int) -> Table:
    return Table({"k": _keys(np.arange(n)[::-1]),
                  "w": make_column(np.arange(n, dtype=np.int32), device="cpu")})


CALLS = {
    "filter": (lambda: filter_table(_table(500), lambda t: t["v"].data < 50).to_table(),
               {("grs.filter", None): 1, ("grs.filter.sync", None): 1}),
    "join": (lambda: join(_table(500), _unique_build(100), "k").to_table(),
             {("grs.join", None): 1, ("grs.join.build", "grs.join"): 1,
              ("grs.sort", "grs.join.build"): 1, ("grs.join.probe", "grs.join"): 1,
              ("grs.filter", "grs.join"): 1, ("grs.join.sync", None): 1}),
    "join_validated": (lambda: join(_table(500), _unique_build(100), "k", how="semi",
                                    validate_unique=True).to_table(),
                       {("grs.join", None): 1, ("grs.join.build", "grs.join"): 1,
                        ("grs.sort", "grs.join.build"): 1, ("grs.join.probe", "grs.join"): 1,
                        ("grs.join.sync", "grs.join.probe"): 1, ("grs.filter", "grs.join"): 1,
                        ("grs.join.sync", None): 1}),
    "join_expand": (lambda: join_expand(_table(500), _table(100, 1), "k").to_table(),
                    {("grs.join", None): 1, ("grs.join.build", "grs.join"): 1,
                     ("grs.sort", "grs.join.build"): 1, ("grs.join.probe", "grs.join"): 1,
                     ("grs.join.sync", None): 1}),
    "group_by": (lambda: group_by_aggregate(_table(500), "k", {"s": ("v", "sum")}).to_table(),
                 {("grs.group_by", None): 1, ("grs.sort", "grs.group_by"): 1,
                  ("grs.group_by.aggregate", "grs.group_by"): 1, ("grs.group_by.sync", None): 1}),
    "sort_table": (lambda: tsort.sort_table(_table(500), "k"), {("grs.sort", None): 1}),
    "sort_pairs_and_keys": (lambda: (tsort.sort_pairs(_keys(range(9, 0, -1))),
                                     tsort.sort_keys(_keys(range(9, 0, -1)), method="radix")),
                            {("grs.sort", None): 2}),
    "host_reads": (lambda: (tsort.skipped_passes(), _keys(range(5)).to_numpy()),
                   {("grs.sort.sync", None): 1, ("grs.column.sync", None): 1}),
}


@pytest.mark.parametrize("call", CALLS)
def test_operator_spans_and_nesting(call, tmp_path):
    fn, want = CALLS[call]
    assert _profiled(fn, tmp_path) == collections.Counter(want)


def test_span_off_is_one_shared_no_op():
    assert not torch.autograd._profiler_enabled()
    off = trace.span("grs.filter")
    assert off is trace.span("grs.join.sync")
    with off as entered:
        assert entered is None
    with profile(activities=[ProfilerActivity.CPU]):
        on = trace.span("grs.filter")
        assert isinstance(on, record_function) and on is not off


def test_a_span_lands_in_the_trace_only_while_the_profiler_records(tmp_path):
    """A span opened while the profiler records lands in the trace; one opened after does not."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("grs.inside"):
            pass
    with trace.span("grs.after"):
        pass
    assert set(_spans(prof, tmp_path)) == {("grs.inside", None)}


def _rows_of(fn) -> dict:
    trace.reset()
    fn()
    return {site: tuple(c) for site, c in trace.counters()["rows"].items() if c != [0, 0]}


def _live(n: int, padded: int) -> Table:
    """``n`` live rows of a ``padded``-row key column and int32 column."""
    keys = np.full(padded, 0xFFFFFFFF, dtype=np.uint32)
    keys[:n] = np.arange(n)[::-1]
    return Table({"k": Column(torch.from_numpy(keys), n),
                  "v": Column(torch.arange(padded, dtype=torch.int32), n)})


# The fused sort walks its live partitions of 4,096 rows (sort_plan.lookback_rows),
# the radix method the whole padded buffer; join's probe its live rows rounded up
# to its kernel's tile (TILE), join_expand's searches the whole padded probe.
TILE = probe_kernels.TILE_ROWS
ROWS = {
    "filter": (lambda: filter_table(_live(1000, 8192), lambda t: t["v"].data % 2 == 0),
               {"compact": (1000, 8192)}),
    "sort_pairs": (lambda: tsort.sort_pairs(_live(1000, 8192)["k"]), {"sort": (1000, 4096)}),
    "sort_keys_radix": (lambda: tsort.sort_keys(_live(1000, 8192)["k"], method="radix"),
                        {"sort": (1000, 8192)}),
    "sort_table": (lambda: tsort.sort_table(_live(1000, 8192), "k"),
                   {"sort": (1000, 4096), "gather": (1000, 8192)}),
    "sort_table_keys_only": (lambda: tsort.sort_table(Table({"k": _live(10, 8192)["k"]}), "k"),
                             {"sort": (10, 4096)}),
    "join_inner": (lambda: join(_live(1000, 8192), _live(300, 16384), "k"),
                   {"sort": (300, 4096), "gather": (300 + 1000, 16384 + 8192),
                    "probe": (1000, TILE), "compact": (1000, 8192)}),
    "join_semi": (lambda: join(_live(1000, 8192), _live(300, 16384), "k", how="semi"),
                  {"sort": (300, 4096), "gather": (300, 16384), "probe": (1000, TILE),
                   "compact": (1000, 8192)}),
    "join_expand": (lambda: join_expand(_live(1000, 8192), _live(300, 8192), "k"),
                    {"sort": (300, 4096), "gather": (300, 8192), "probe": (2000, 16384)}),
    "group_by": (lambda: group_by_aggregate(_live(1000, 8192), "k", {"s": ("v", "sum")}),
                 {"sort": (1000, 4096), "aggregate": (1000, 8192)}),
    "aggregate_device_count": (lambda: aggregate_sorted_flat(
        _live(1000, 8192)["k"].data, torch.tensor(1000), [("c", None, "count")]), {}),
}


@pytest.mark.parametrize("call", ROWS)
def test_row_counters_are_exact(call):
    fn, want = ROWS[call]
    assert _rows_of(fn) == want


# Pad rows a gather writes from row 0, once an index: sort_table's past its
# permutation's length; join's own gathers read their whole index.
FILLED = {
    "sort_table": (ROWS["sort_table"][0], 8192 - 1000),
    "sort_table_keys_only": (ROWS["sort_table_keys_only"][0], 0),
    "sort_table_all_live": (lambda: tsort.sort_table(_live(4096, 4096), "k"), 0),
    "sort_table_none_live": (lambda: tsort.sort_table(_live(0, 4096), "k"), 4096),
    "join_inner": (ROWS["join_inner"][0], 16384 - 300),
    "join_expand": (ROWS["join_expand"][0], 8192 - 300),
    "group_by": (ROWS["group_by"][0], 0),
}


@pytest.mark.parametrize("call", FILLED)
def test_gather_filled_counts_pad_rows(call):
    fn, want = FILLED[call]
    trace.reset()
    fn()
    assert trace.counters()["gather_filled"] == want
    trace.reset()
    assert trace.counters()["gather_filled"] == 0


# Pad rows join's probe writes without a search, its keys unread: the padded
# probe past the live rows rounded up to a tile.
PROBE_FILLED = {
    "join_inner": (ROWS["join_inner"][0], 8192 - TILE),
    "join_semi": (ROWS["join_semi"][0], 8192 - TILE),
    "join_anti_none_live": (lambda: join(_live(0, 8192), _live(300, 16384), "k", how="anti"),
                            8192),
    "join_all_live": (lambda: join(_live(8192, 8192), _live(300, 16384), "k"), 0),
    "join_off_tile": (lambda: join(_live(TILE + 1, 4 * TILE), _live(300, 16384), "k"),
                      2 * TILE),
    "join_expand": (ROWS["join_expand"][0], 0),
    "sort_table": (ROWS["sort_table"][0], 0),
}


@pytest.mark.parametrize("call", PROBE_FILLED)
def test_probe_filled_counts_unsearched_pad_rows(call):
    fn, want = PROBE_FILLED[call]
    trace.reset()
    fn()
    snap = trace.counters()
    assert snap["probe_filled"] == want
    if call.startswith("join_") and call != "join_expand":  # with the walked rows, the probe
        live, walked = snap["rows"]["probe"]
        assert walked + want == (4 * TILE if call == "join_off_tile" else 8192)
        assert 0 <= walked - live < TILE
    trace.reset()
    assert trace.counters()["probe_filled"] == 0


def test_reset_zeroes_rows_and_captures():
    trace.rows("probe", 3, 8)
    trace.graph_captured()
    assert trace.counters()["graphs"]["captured"] >= 1
    trace.reset()
    snap = trace.counters()
    assert snap["rows"] == {site: [0, 0] for site in trace.SITES}
    assert snap["graphs"]["captured"] == 0


def test_counters_read_the_counts_where_they_stand(monkeypatch):
    """The wrappers' launches, the graphs' replays and the skipped passes, none copied."""
    wrappers = trace.kernel_wrappers()
    for fn in wrappers.values():
        monkeypatch.setattr(fn, "launches", fn.launches)
    wrappers["dest_scatter"].launches += 7
    graphs = {1: type("G", (), {"replays": 3})(), 2: type("G", (), {"replays": 4})()}
    monkeypatch.setattr(tsort, "_SORT_GRAPHS", graphs)
    monkeypatch.setattr(tsort, "_SKIPPED", {"cpu": torch.tensor([5])})
    snap = trace.counters()
    assert snap["launches"] == {name: fn.launches for name, fn in wrappers.items()}
    assert snap["launches"]["dest_scatter"] == wrappers["dest_scatter"].launches
    assert snap["graphs"]["replayed"] == 7
    assert snap["passes_skipped"] == 5
    assert launch.KERNEL_WRAPPERS == wrappers


@pytest.fixture(scope="module")
def tiny_db():
    return load(tpch.generate({"scale_factor": TINY_SF}, SEED, "cpu"))


@pytest.fixture(scope="module")
def profiled_queries(tiny_db, tmp_path_factory):
    """Each query run twice under the profiler: (its spans, its row counts, its Probe)."""
    out = {}
    for name, (plan, params, _) in PLANS.items():
        trace.reset()
        probe = Probe(None)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for _ in range(2):
                with record_function(devicetime.QUERY_SPAN):
                    plan.run(tiny_db, params, probe)
        out[name] = (_spans(prof, tmp_path_factory.mktemp(name)), trace.counters()["rows"], probe)
    return out


@pytest.mark.parametrize("query", PLANS)
def test_queries_gather_their_top_k_without_reading_pad_rows(tiny_db, query, monkeypatch):
    # Each query's top-k sort_tables, and its joins' build sorts, gather
    # through permutations of few live rows.  Each such gather gives the
    # same bytes with the permutation's pad rows scrambled, so it reads
    # none of them; gather_filled counts exactly those pad rows, and the
    # gather site counts them among its walked rows, since they are written.
    plan, params, _ = PLANS[query]
    gather = tsort.gather_columns
    calls = []

    def scrambled_pads(values, src, live=None, impl=None):
        got = gather(values, src, live, impl)
        other = src.clone()
        other[live:] = torch.randint(-5, 1 << 20, (src.numel() - live,), dtype=src.dtype)
        again = gather(values, other, live, impl)
        assert all(torch.equal(a.view(torch.uint8), b.view(torch.uint8))
                   for a, b in zip(got, again))
        calls.append((src.numel(), live))
        return got

    monkeypatch.setattr(tsort, "gather_columns", scrambled_pads)
    trace.reset()
    plan.run(tiny_db, params, Probe(None))
    snap = trace.counters()
    filled = sum(n - live for n, live in calls)
    live, walked = snap["rows"]["gather"]
    assert filled > 0
    assert snap["gather_filled"] == filled
    assert walked - live >= filled


@pytest.mark.parametrize("query", PLANS)
def test_queries_make_their_operators_syncs(profiled_queries, query):
    spans, _, _ = profiled_queries[query]
    syncs = sum(n for (name, _), n in spans.items() if sync_idle_ms.is_sync(name))
    assert syncs == 2 * PLANS[query][2]
    assert spans["qbench.query", None] == 2
    assert all(holder is not None and holder.startswith("qbench.")
               for (name, holder) in spans if sync_idle_ms.is_sync(name))


@pytest.mark.parametrize("query", PLANS)
def test_sort_site_agrees_with_the_benchmarks_sorted_bytes(profiled_queries, query):
    _, rows, probe = profiled_queries[query]
    assert probe.sort_bytes > 0
    assert SORT_ROW_BYTES * rows["sort"][0] == probe.sort_bytes
    assert all(0 <= live <= walked for live, walked in rows.values())


def _trace(device, spans, queries=1) -> devicetime.Trace:
    spans = [(devicetime.QUERY_SPAN, 10.0 * q, 10.0 * q + 10.0) for q in range(queries)] + spans
    return devicetime.Trace(0.0, 10.0 * queries, device, spans)


def _record(trace_=None) -> RunRecord:
    return RunRecord([0.1], 1.0, 1, 1, None, 1.0, None, trace_, 0, 0)


# Device busy 0-1, 3-4, 6-7 and 9-10 s of one 10 s query: gaps 1-3 (in a sync
# span), 4-6 (in a phase of the port), 7-9 (in the plan's glue, no port span).
GAPPED = _trace([("k", 0.0, 1.0), ("k", 3.0, 4.0), ("k", 6.0, 7.0), ("k", 9.0, 10.0)],
                [("grs.join", 0.5, 6.5), ("grs.join.sync", 0.9, 3.1),
                 ("grs.join.probe", 3.5, 6.2), ("qbench.join", 0.4, 8.0)])


def test_idle_readers_partition_the_idle_time():
    idle = GAPPED.window_s - GAPPED.busy_s()
    sync, launch = sync_idle_ms.read(_record(GAPPED)), launch_idle_ms.read(_record(GAPPED))
    assert sync == pytest.approx(2e3) and launch == pytest.approx(2e3)
    outside = sum(g for name, g in GAPPED.idle_gaps() if not name.startswith("grs."))
    assert outside == pytest.approx(2.0)
    assert (sync + launch) / 1e3 + outside == pytest.approx(idle)
    assert host_syncs.read(_record(GAPPED)) == 1


def test_idle_readers_divide_by_the_queries():
    two = _trace([("k", 0.0, 1.0), ("k", 3.0, 20.0)],
                 [("grs.group_by.sync", 0.5, 4.0), ("grs.filter.sync", 12.0, 13.0)], queries=2)
    assert sync_idle_ms.read(_record(two)) == pytest.approx(1e3)
    assert launch_idle_ms.read(_record(two)) == 0
    assert host_syncs.read(_record(two)) == 1


def test_a_gap_outside_the_ports_spans_counts_in_neither():
    glue = _trace([("k", 0.0, 1.0), ("k", 5.0, 10.0)],
                  [("qbench.sort", 0.5, 6.0), ("grs.sort", 5.5, 6.0)])
    assert sync_idle_ms.read(_record(glue)) == 0
    assert launch_idle_ms.read(_record(glue)) == 0
    assert host_syncs.read(_record(glue)) == 0


@pytest.mark.parametrize("reader", SPAN_READERS, ids=lambda r: r.__name__.split(".")[-1])
def test_span_readers_return_none_without_a_trace_or_the_ports_spans(reader):
    assert reader.read(_record()) is None
    bare = _trace([("k", 0.0, 1.0), ("k", 5.0, 10.0)], [("qbench.join", 0.5, 6.0)])
    assert reader.read(_record(bare)) is None
    assert reader.read(_record(_trace([], [], queries=0))) is None


def test_live_row_share_reads_the_counters_or_none(monkeypatch):
    trace.reset()
    assert live_row_share.read(_record()) is None  # nothing counted
    trace.rows("sort", 30, 40)
    trace.rows("compact", 10, 60)
    assert live_row_share.read(_record()) == pytest.approx(40.0)
    monkeypatch.delattr(gpuradixsort_tpu_torch.utils, "trace")
    monkeypatch.setitem(sys.modules, "gpuradixsort_tpu_torch.utils.trace", None)
    assert live_row_share.read(_record()) is None  # a port without the module
    trace.reset()


# -- on the card: the host syncs the port makes lie inside its sync spans ------

SYNC_WARNING = "called a synchronizing CUDA operation"  # not the mode's one-time notice
PORT_DIR = "gpuradixsort_tpu_torch"


def syncs_of(run_query) -> tuple[collections.Counter, list, int]:
    """The host syncs ``run_query()`` makes, under ``torch.cuda.set_sync_debug_mode("warn")``.

    Returns (the port's syncs by the sync span they lie in, the port's
    syncs outside any sync span as "file:line", the syncs made outside
    the port).  A sync is the port's where the innermost frame that asked
    for it lies in the port's package.
    """
    open_spans: list[str] = []
    real_span = trace.span
    inside, outside, elsewhere = collections.Counter(), [], 0

    class Tracked:
        def __init__(self, name):
            self.name, self.inner = name, real_span(name)

        def __enter__(self):
            open_spans.append(self.name)
            return self.inner.__enter__()

        def __exit__(self, *exc):
            open_spans.pop()
            return self.inner.__exit__(*exc)

    def seen(message, category, filename, lineno, file=None, line=None):
        nonlocal elsewhere
        if SYNC_WARNING not in str(message):
            return
        frames = traceback.extract_stack()[:-1]
        while frames[-1].filename.endswith("warnings.py"):
            frames.pop()
        site = frames[-1]
        if PORT_DIR not in site.filename:
            elsewhere += 1
        elif open_spans and sync_idle_ms.is_sync(open_spans[-1]):
            inside[open_spans[-1]] += 1
        else:
            outside.append(f"{site.filename}:{site.lineno}")

    trace.span = Tracked
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = seen
            torch.cuda.set_sync_debug_mode("warn")
            try:
                run_query()
            finally:
                torch.cuda.set_sync_debug_mode(0)
    finally:
        trace.span = real_span
    torch.cuda.synchronize()
    return inside, outside, elsewhere


@pytest.mark.cuda
@pytest.mark.parametrize("query", PLANS)
def test_every_sync_of_the_port_lies_in_a_sync_span(query):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    plan, params, syncs = PLANS[query]
    db = load(tpch.generate({"scale_factor": TINY_SF}, SEED, torch.device("cuda", 0)))
    for _ in range(3):  # every kernel built, every sort graph captured
        plan.run(db, params, Probe(None))
    inside, outside, elsewhere = syncs_of(lambda: plan.run(db, params, Probe(None)))
    assert outside == []
    assert sum(inside.values()) == syncs
    assert elsewhere > 0  # the benchmark's own reads of the answer
