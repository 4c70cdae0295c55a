"""Benchmark: stable (key, index) sort at 1M / 16M / 64M keys, and a 64-byte-row table sort.

    python -m gpuradixsort_tpu_torch.bench [--sizes N [N ...]] [--device cpu] [--out DIR]

The PyTorch counterpart of the repo's ``bench.py``.  It sorts the same
inputs, drawn from the same seed in the same order: each size's keys (a
permutation of 0..n-1 up to 2^26 keys, else random), the stage table's
keys, then the table sort's keys and its 16 int32 payload columns.  The
methods are the sort's private entry points on pre-padded buffers, as in
``bench.py``: ``"torch"`` (``torch.sort``, the library baseline, where
``bench.py`` has XLA's ``lax.sort``), ``"fused"`` and ``"radix"``; all three
at 1M keys and below, the library and fused sorts above.

On the card it logs, to stderr:

- each method at each size: ms per sort by CUDA events over k back-to-back
  sorts after a warm-up of k (k = 48, 8 and 2 at 1M, 16M and 64M keys;
  median of 5 runs), keys/s, the device's busy time per sort
  (torch.profiler), for the fused and radix sorts whether they replayed a
  cached CUDA graph or ran eagerly, and for the fused sort the passes its
  plan skipped (read from the card's counter around the checked calls,
  never inside a timed run);
- the per-stage table of one fused pass at shift 0 (``stage_table``), also
  written to ``durations_cuda.txt`` in ``--out`` below the card's name and
  power limit;
- the headline size's table sort: the fused sort, then a gather of its
  64-byte rows through the permutation;
- the wall time.

The last line of stdout is one JSON object: the best method at the headline
size (1M, or the first of ``--sizes`` without it) as keys/s, ``vs_baseline``
against the reference's 1,048,576 keys in 6,165 us, and the card's name and
power limit from ``nvidia-smi``.

Every result is checked exactly against numpy: each method's live keys and
permutation (``np.argsort(kind="stable")``) on its first call and again
after its timing, and the table sort's live rows likewise.

Deliberate differences from ``bench.py``:

- No fallback.  A method that raises, or a check that fails, ends the bench
  with exit code 1; ``bench.py`` logs either and carries on, and fails only
  when no method verified at 1M.
- No chained remix of the keys between sorts: that works around a remote
  TPU which memoizes repeated calls, and a local card needs none.
- ``--device cpu`` runs every method and every check on the CPU at
  ``--sizes`` and times nothing; its JSON line has ``"value": null``.
  Without a card, and without ``--device cpu``, the bench raises.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from gpuradixsort_tpu_torch.config import PAD_INDEX, PAD_KEY, EngineConfig, default_device
from gpuradixsort_tpu_torch.core.table import int32_bits, pad_to_tile
from gpuradixsort_tpu_torch.kernels import radix as rk
from gpuradixsort_tpu_torch.kernels.bucketize import bucketize_tiles
from gpuradixsort_tpu_torch.kernels.gather import gather_columns
from gpuradixsort_tpu_torch.kernels.sort_plan import (
    ARGS_WORDS,
    COUNT_LINES,
    SortArgs,
    lookback_partitions,
    lookback_words,
    sort_args,
    sort_plan,
)
from gpuradixsort_tpu_torch.kernels.scatter import bucketize_scatter_lookback, scatter_runs
from gpuradixsort_tpu_torch.ops import sort as sort_ops
from gpuradixsort_tpu_torch.utils.timing import (
    HBM_PEAK_TBS,
    bound_of,
    card_line,
    per_call_ms,
    profiled_device_ms,
)

# Reference baseline: 1,048,576 pairs / 6,165 us (durations.txt:1).
BASELINE_KEYS_PER_S = 1_048_576 / 6.165e-3

HEADLINE_N = 1_000_000
SIZES = (HEADLINE_N, 16 << 20, 64 << 20)
SEED = 20170101
PAYLOAD_COLS = 16  # 64-byte rows
RUNS = 5  # timed runs of back-to-back calls; their median is reported
TABLE_CHAIN = 8  # back-to-back table sorts a run, as bench.py chains them
STAGE_CALLS = 32  # back-to-back launches of one stage a run, as bench.py chains them
PROFILED_SORTS = 3  # calls a profile of a sort; two or more, so that a dropped launch shows
PROFILED_STAGE_CALLS = 20
DURATIONS_FILE = "durations_cuda.txt"


def log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


class BenchFailure(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        log(f"FAIL  {what}")
        raise BenchFailure(what)
    log(f"PASS  {what}")


def methods_for(n: int) -> tuple[str, ...]:
    """The methods sorted at ``n`` keys: bench.py's 1M set at 1M and below, its 16M/64M set above."""
    return ("torch", "fused", "radix") if n <= HEADLINE_N else ("torch", "fused")


def chain_for(n: int) -> int:
    """Back-to-back sorts a timed run: bench.py's chain lengths at 1M, 16M and 64M."""
    return 48 if n <= HEADLINE_N else (8 if n <= (16 << 20) else 2)


def iota(n: int, device) -> torch.Tensor:
    """0..n-1 as uint32."""
    return torch.arange(n, dtype=torch.int32, device=device).view(torch.uint32)


def make_inputs(n: int, cfg: EngineConfig, rng, device):
    """bench.py's inputs: host keys, and padded keys and index on ``device``.

    The keys are a permutation of 0..n-1 for n <= 2^26, else random; the
    padded keys carry PAD_KEY past n, the index 0..n-1 then PAD_INDEX.
    """
    keys_np = rng.permutation(n).astype(np.uint32) if n <= (1 << 26) else (
        rng.integers(0, 2**32, n, dtype=np.uint32)
    )
    keys = pad_to_tile(torch.from_numpy(keys_np).to(device), cfg, PAD_KEY)
    idx = pad_to_tile(iota(n, device), cfg, PAD_INDEX)
    return keys_np, keys, idx


def sort_padded(method: str, keys: torch.Tensor, idx: torch.Tensor, cfg: EngineConfig):
    """(keys, idx) of padded buffers sorted by one method's private entry point."""
    if method == "torch":
        return sort_ops._torch_sort_padded(keys, idx)
    if method == "fused":
        out_keys, out_idx, _ = sort_ops._fused_sort_padded(keys, idx, cfg)  # no overflow
        return out_keys, out_idx
    if method == "radix":
        out_keys, (out_idx,) = sort_ops._sort_padded(keys, (idx,), cfg)
        return out_keys, out_idx
    raise ValueError(f"unknown bench method: {method}")


def pairs_match(keys_out: torch.Tensor, idx_out: torch.Tensor, keys_np: np.ndarray,
                order: np.ndarray) -> bool:
    """The live keys equal ``keys_np[order]`` and the live index ``order``.

    ``order`` is ``np.argsort(keys_np, kind="stable")``.
    """
    n = keys_np.size
    return (np.array_equal(keys_out[:n].cpu().numpy(), keys_np[order])
            and np.array_equal(idx_out[:n].cpu().numpy(), order.astype(np.uint32)))


def table_sort(keys: torch.Tensor, idx: torch.Tensor, payload: torch.Tensor, cfg: EngineConfig):
    """The fused sort of (keys, idx), then the payload's rows gathered through the permutation.

    As in ``sort_table``, the index is read as int32, so a pad row's
    PAD_INDEX gathers row 0.
    """
    _, perm, _ = sort_ops._fused_sort_padded(keys, idx, cfg)
    return gather_columns([payload], int32_bits(perm))[0]


def rows_match(rows_out: torch.Tensor, payload_np: np.ndarray, order: np.ndarray) -> bool:
    """The live rows equal ``payload_np[order]``."""
    return np.array_equal(rows_out[: order.size].cpu().numpy(), payload_np[order])


def stage_work(padded: int, cfg, words: int = 2, agg_columns: int = 1,
               agg_outputs: int = 6, agg_rows: bool = False) -> dict[str, tuple[int, int]]:
    """(bytes it must move, integer operations it must do) of each stage on ``padded`` keys.

    Each input is read once and each output written once; a table is one
    (tiles, radix) int32 table.  ``exclusive_scan`` is the scan of a vector
    of ``padded`` int32 values; ``global_offsets`` is one pass's scan of the
    histogram table; ``bucketize_scatter_lookback`` counts each
    partition's digits itself and writes and reads its pass's status words
    (8 bytes a partition and digit); ``sort_plan`` reads the keys and writes the AND
    and OR, the plan, every pass's digit counts and bases, and the cleared
    lines it sums the counts in and look-back scratch of every pass, and
    adds a counter a pass to each key; ``sort_args`` writes the argument
    block from its launch's arguments; ``dest_scatter`` reads two table
    rows a tile and reads and writes ``words`` 4-byte words a row (by
    default a radix pass's key and its index), its rank keys being the
    first of them, read once;
    ``gather_rows`` moves a row of ``PAYLOAD_COLS`` int32 through a 4-byte
    index; ``segment_aggregate`` reads the keys and ``agg_columns`` distinct
    4-byte columns and writes ``agg_outputs`` 4-byte outputs (the group keys
    among them) whole, a zeroing memset and the groups' rows together, with
    one comparison a row and one combine a row an aggregate (by default the
    group-by of ``chip_smoke.py``: one column, five aggregates); with
    ``agg_rows`` it also reads the sort's 4-byte permutation, through which
    it reads the columns (each input byte counted once: the columns' 32-byte
    sectors at random rows are ``gather_sector_bytes``, a note, not the bound).
    """
    tiles = padded // cfg.tile
    table = 4 * cfg.radix * tiles
    status = 8 * cfg.radix * lookback_partitions(padded)  # one pass's status words
    passes = cfg.num_passes
    return {
        "sort_args": (8 * ARGS_WORDS, 0),
        "sort_plan": (4 * padded + 8 + 4 * passes * (1 + 2 * cfg.radix)
                      + 4 * (COUNT_LINES + lookback_words(tiles, cfg)), (2 + passes) * padded),
        "bucketize_scatter_lookback": (16 * padded + 2 * status, 6 * padded),
        "radix_hist": (4 * padded + table, 3 * padded),
        "global_offsets": (2 * table, table // 4),
        "bucketize": (16 * padded, 4 * padded),
        "scatter_runs": (16 * padded + 2 * table, 2 * padded),
        "radix_dest": (8 * padded + table, 4 * padded),
        "dest_scatter": (8 * words * padded + 2 * table, 4 * padded),
        "exclusive_scan": (8 * padded + 4, padded),
        "gather_rows": ((4 + 2 * 4 * PAYLOAD_COLS) * padded, 0),
        "segment_aggregate": (4 * (1 + agg_columns + agg_outputs + agg_rows) * padded,
                              agg_outputs * padded),
    }


def gather_sector_bytes(live: int, columns: int = 1) -> int:
    """The device bytes a read of ``columns`` 4-byte columns at ``live`` random rows moves.

    One 32-byte sector a row and column, where the column is too large for
    the L2 cache to hold a sector for a later row: what a gather through a
    sort's permutation costs beyond the 4 bytes ``stage_work`` counts.
    """
    return 32 * live * columns


# The stage table's rows: its label (bench.py's, the scatter named for the
# CUDA K3, which has no window) and the stage_work entry.  A fused sort runs
# the key read with its digit counts once and the look-back pass in every
# pass.  The histogram, the offsets, the bucketize and the scatter_runs rows
# time the four kernels whose work the look-back pass does; all of them
# still stand for the JAX package's functions.
STAGES = {
    "key read with digit counts (once)": "sort_plan",
    "look-back bucketize+scatter kernel (per pass)": "bucketize_scatter_lookback",
    "histogram kernel (per pass)": "radix_hist",
    "global offsets (per pass)": "global_offsets",
    "bucketize kernel (per pass)": "bucketize",
    "scatter_runs kernel (per pass)": "scatter_runs",
    "payload gather 64B rows (once)": "gather_rows",
}


def stage_table(keys: torch.Tensor, cfg: EngineConfig, timed: bool) -> list[dict]:
    """One fused pass at shift 0 on the padded ``keys``, stage by stage.

    For each stage: the bytes it must move, its bound (``bound_of``: the
    bytes at the HBM rate), and where ``timed`` the ms per launch by CUDA
    events over STAGE_CALLS back-to-back launches (median of RUNS runs), the
    device ms per launch from torch.profiler (None where no whole profile
    was taken) and the share of the bound in that device time.  Untimed,
    each stage runs once.  The gather takes the fused sort's permutation of
    these keys, as the table sort does.  A look-back launch needs its pass's
    scratch clear, which a sort's ``sort_plan`` does once; here each launch
    clears it first (and writes its argument block), so its events include
    that fill and its device time is the kernel's own.  ``sort_plan`` reads
    one argument block, written before, as a sort writes one a sort.
    """
    padded = keys.numel()
    idx = iota(padded, keys.device)
    skipped = torch.zeros(1, dtype=torch.int64, device=keys.device)
    block = sort_args(SortArgs(keys, None, (None, None), padded))
    state = sort_plan(keys, cfg, skipped, block=block)
    hist = rk.tile_histograms(keys, 0, cfg)
    offsets = rk.global_offsets(hist)
    bk, bi = bucketize_tiles(keys, idx, 0, cfg)
    _, perm, _ = sort_ops._fused_sort_padded(keys, idx, cfg)
    src = int32_bits(perm)
    payload = torch.zeros((padded, PAYLOAD_COLS), dtype=torch.int32, device=keys.device)
    def lookback():
        state.lookback.zero_()
        return bucketize_scatter_lookback(keys, idx, cfg, state, 0)

    fns = {
        "sort_plan": lambda: sort_plan(keys, cfg, skipped, block=block),
        "bucketize_scatter_lookback": lookback,
        "radix_hist": lambda: rk.tile_histograms(keys, 0, cfg),
        "global_offsets": lambda: rk.global_offsets(hist),
        "bucketize": lambda: bucketize_tiles(keys, idx, 0, cfg),
        "scatter_runs": lambda: scatter_runs(bk, bi, hist, offsets, cfg),
        "gather_rows": lambda: gather_columns([payload], src)[0],
    }
    work = stage_work(padded, cfg)
    rows = []
    for label, name in STAGES.items():
        nbytes, ops = work[name]
        bound_ms, _ = bound_of(nbytes, ops)
        event_ms = device_ms = None
        if timed:
            event_ms = float(np.median(per_call_ms(fns[name], calls=STAGE_CALLS, reps=RUNS)))
            busy, by_row = profiled_device_ms(fns[name], calls=PROFILED_STAGE_CALLS)
            if name == "bucketize_scatter_lookback":  # the kernel's rows, not the fill's
                busy = sum(ms for row, ms in by_row.items() if "lookback_scatter" in row)
            device_ms = busy or None
        else:
            fns[name]()
        rows.append({"stage": label, "bytes": nbytes, "bound_ms": bound_ms,
                     "event_ms": event_ms, "device_ms": device_ms,
                     "share": bound_ms / device_ms if device_ms else None})
    return rows


def _us(ms) -> str:
    return "not measured" if ms is None else f"{ms * 1e3:.2f} us"


def stage_text(rows: list[dict], card: str, n: int, padded: int) -> str:
    """The stage table in bench.py's durations style, below the card's line."""
    lines = [
        card,
        f"one fused pass at shift 0, radix 16, on {n} keys ({padded} padded); per launch: CUDA "
        f"events over {STAGE_CALLS} back-to-back launches (median of {RUNS} runs) and device "
        f"time (torch.profiler, {PROFILED_STAGE_CALLS} launches); bound: the bytes the stage "
        f"must move at {HBM_PEAK_TBS} TB/s; share: bound over device time",
        "L2: at 1M keys a stage's inputs (4-16 MB) stay in the H100's 50 MB L2 between "
        "back-to-back launches, as between the passes of a sort, so a share above 1.0 of the "
        "HBM bound can come from L2 and is not an error",
    ]
    for r in rows:
        share = "not measured" if r["share"] is None else f"{r['share']:.3f}"
        lines.append(f"{r['stage']}: {_us(r['event_ms'])} per launch by events, "
                     f"{_us(r['device_ms'])} device, {r['bytes'] / 1e6:.3f} MB, "
                     f"bound {r['bound_ms'] * 1e3:.3f} us, share of bound {share}")
    return "\n".join(lines)


def graph_path(method: str, keys: torch.Tensor, idx: torch.Tensor, cfg: EngineConfig) -> str:
    """How ``method``'s sorts of (keys, idx) ran: a cached CUDA graph's replays, or eagerly."""
    graph = sort_ops._SORT_GRAPHS.get(sort_ops.graph_key(method, (keys, idx), cfg))
    if graph is not None:
        return f"passes by a cached CUDA graph, replayed {graph.replays} times"
    return "passes run eagerly (no cached graph)"


def checked_skips(fn, what: str, ok) -> int:
    """Passes the fused sorts of one call of ``fn`` skipped, after ``ok(*fn())`` is checked."""
    before = sort_ops.skipped_passes()
    check(ok(*fn()), what)
    return sort_ops.skipped_passes() - before


def timed_ms(fn, calls: int) -> tuple[float, float]:
    """(ms a call by CUDA events, median of RUNS runs of ``calls`` back-to-back calls after a
    warm-up run; device busy ms a call from torch.profiler, 0.0 where not measured)."""
    ms = float(np.median(per_call_ms(fn, calls=calls, reps=RUNS)))
    return ms, profiled_device_ms(fn, calls=PROFILED_SORTS)[0]


def _busy(ms: float) -> str:
    return f"{ms:.4f} ms" if ms else "not measured"


def run_sizes(sizes, cfg, rng, device, timed: bool) -> dict:
    """Every method at every size, each checked before and after its timing; returns ms a sort."""
    results: dict[int, dict[str, float | None]] = {}
    for n in sizes:
        keys_np, keys, idx = make_inputs(n, cfg, rng, device)
        order = np.argsort(keys_np, kind="stable")
        results[n] = {}
        for method in methods_for(n):
            fn = lambda: sort_padded(method, keys, idx, cfg)  # noqa: E731
            what = f"n={n} {method}: live keys == np.sort, permutation == np.argsort(stable)"
            ok = lambda k, i: pairs_match(k, i, keys_np, order)  # noqa: E731
            skips = [checked_skips(fn, f"{what} (first call)", ok)]
            if not timed:
                results[n][method] = None
                continue
            k = chain_for(n)
            ms, busy = timed_ms(fn, k)
            skips.append(checked_skips(fn, f"{what} (after the timed runs)", ok))
            path = ""
            if method != "torch":
                path = f"; {graph_path(method, keys, idx, cfg)}"
            if method == "fused":
                check(skips[0] == skips[1], f"n={n} fused: the plan skipped {skips[0]} of "
                      f"{cfg.num_passes} passes, eagerly and after the timed runs")
            log(f"n={n:>9} {method:>5}: {ms:.4f} ms/sort by CUDA events ({k} back-to-back, "
                f"median of {RUNS}), {n / ms / 1e3:.1f} M keys/s; device busy {_busy(busy)} "
                f"a sort{path}")
            results[n][method] = ms
        del keys, idx, keys_np, order
    return results


def run_table_sort(n: int, cfg, rng, device, timed: bool) -> None:
    """The table sort of n keys and 64-byte rows, checked before and after its timing."""
    keys_np, keys, idx = make_inputs(n, cfg, rng, device)
    payload_np = rng.integers(0, 2**31, (keys.shape[0], PAYLOAD_COLS), dtype=np.int64).astype(
        np.int32)
    payload = torch.from_numpy(payload_np).to(device)
    order = np.argsort(keys_np, kind="stable")
    fn = lambda: table_sort(keys, idx, payload, cfg)  # noqa: E731
    what = f"n={n} table sort (fused + 64B-row gather): live rows == payload[np.argsort(stable)]"
    check(rows_match(fn(), payload_np, order), f"{what} (first call)")
    if timed:
        ms, busy = timed_ms(fn, TABLE_CHAIN)
        check(rows_match(fn(), payload_np, order), f"{what} (after the timed runs)")
        log(f"n={n:>9} 64B-row table sort (fused): {ms:.4f} ms by CUDA events ({TABLE_CHAIN} "
            f"back-to-back, median of {RUNS}), {n / ms / 1e3:.1f} M rows/s; device busy "
            f"{_busy(busy)}")


def headline(results: dict, n: int, device_name: str, power_limit) -> dict:
    """bench.py's JSON line: the fastest checked method at ``n`` keys, and the card."""
    times = {m: ms for m, ms in results[n].items() if ms is not None}
    best = min(times, key=times.get) if times else None
    value = n / (times[best] / 1e3) if best else None
    return {
        "metric": f"uint32 keys/s, stable {n:,} key+index sort, single card "
                  + (f"(best method: {best})" if best else "(not timed: run on the CPU)"),
        "value": round(value) if value else None,
        "unit": "keys/s",
        "vs_baseline": round(value / BASELINE_KEYS_PER_S, 3) if value else None,
        "device": {"name": device_name, "power_limit": power_limit},
    }


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        prog="python -m gpuradixsort_tpu_torch.bench",
        description="Sort benchmark of the port: every result checked against numpy; the "
                    "headline JSON line last on stdout, everything else on stderr.")
    parser.add_argument("--sizes", type=int, nargs="+", default=list(SIZES),
                        help="key counts to sort (default: 1M, 16M and 64M)")
    parser.add_argument("--device", default=None,
                        help="the device (default: the CUDA card); 'cpu' runs every method and "
                             "check on the CPU and times nothing")
    parser.add_argument("--out", default=".", help=f"directory for {DURATIONS_FILE}")
    args = parser.parse_args(argv)
    if any(n < 1 for n in args.sizes):
        parser.error("--sizes must be positive")
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    device = default_device(args.device)  # raises without a card unless device="cpu"
    timed = device.type == "cuda"
    t0 = time.perf_counter()
    cfg = EngineConfig()
    rng = np.random.default_rng(SEED)
    if timed:
        card = card_line()
        device_name, power_limit = (s.strip() for s in card.rsplit(",", 1))
    else:
        card, device_name, power_limit = f"{device.type}: nothing timed", device.type, None
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; device {device}; {card}")
    hl_n = HEADLINE_N if HEADLINE_N in args.sizes else args.sizes[0]
    try:
        results = run_sizes(args.sizes, cfg, rng, device, timed)

        _, keys, _ = make_inputs(hl_n, cfg, rng, device)
        text = stage_text(stage_table(keys, cfg, timed), card, hl_n, keys.numel())
        del keys
        log("fused per-stage breakdown:")
        for line in text.splitlines():
            log("  " + line)
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, DURATIONS_FILE), "w") as f:
            f.write(text + "\n")

        run_table_sort(hl_n, cfg, rng, device, timed)
    finally:
        sort_ops.clear_sort_graphs()
        if timed:
            torch.cuda.empty_cache()
    line = headline(results, hl_n, device_name, power_limit)
    log(f"headline at n={hl_n}: {line['metric']}; wall {time.perf_counter() - t0:.1f} s")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
