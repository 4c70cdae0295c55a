"""What every runner of a cell shares: the record the metrics read, the comparison, the result.

A runner (``qbench/runners/<runner>.py``) drives the cell's window and
fills a ``RunRecord``; ``verify`` holds its answers and kept operator
outputs against the plain reference; ``result`` reads the cell's metrics
(``qbench/metrics/<name>.py``) from the record and makes the result's
line and the lines naming each number compared beside its limit.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from qbench import check, devicetime, registry


@dataclass
class RunRecord:
    """What the metric readers (``qbench/metrics``) read."""

    latencies_s: list
    window_s: float
    rows_per_query: int
    resident_bytes: int
    memory_peak_window: int | None
    setup_s: float
    spans: dict | None
    trace: devicetime.Trace | None
    sort_bytes: int
    compact_bytes: int


def _short(name: str) -> str:
    """A device operation's name without its arguments, at most 100 characters."""
    name = name.replace("(anonymous namespace)::", "").removeprefix("void ")
    return name.split("(")[0][:100]


def breakdown(trace: devicetime.Trace) -> dict:
    """The ten device operations that took most time, and the ten longest idle gaps."""
    ops: dict[str, float] = {}
    for name, s, e in trace.device:
        ops[_short(name)] = ops.get(_short(name), 0.0) + e - s
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(trace.idle_gaps(), key=lambda g: -g[1])[:10]
    return {"device_ops": [[n, s] for n, s in top], "idle_gaps": [[n, s] for n, s in gaps]}


def verify(reference, ref, answers: list, kept) -> tuple[dict, int]:
    """The numbers compared, {name: (value, limit)}, and the queries answered wrong.

    ``reference`` is the query's reference module, ``ref`` its
    ``Reference`` over the tables made again from the seed, ``answers``
    (params, answer) pairs, ``kept`` (params, {operator: output}).
    """
    limit = reference.FLOAT_LIMIT or 0.0
    by_params: dict[tuple, list] = {}
    for params, answer in answers:
        by_params.setdefault(tuple(sorted(params.items())), []).append(answer)
    rows_wrong, failed, widest = 0, 0, 0.0
    for key, group in by_params.items():
        top, rows = ref.expect(dict(key))
        for answer in group:
            wrong, gap = check.compare_answer(answer, top, rows, reference.KEY, reference.ORDER,
                                              limit)
            rows_wrong += wrong
            widest = max(widest, gap)
            failed += bool(wrong) or gap > limit
    op_wrong = 0
    params, outputs = kept
    for name, expected in ref.operators(params).items():
        wrong, gap = check.compare_table(outputs.get(name, {}), expected, limit)
        op_wrong += wrong
        widest = max(widest, gap)
    numbers = {"answer_rows_wrong": (rows_wrong, 0), "operator_rows_wrong": (op_wrong, 0)}
    if reference.FLOAT_LIMIT is not None:
        numbers[reference.GAP_NAME] = (widest, reference.FLOAT_LIMIT)
    return numbers, failed


def result(bench: dict, cell: dict, trace: bool, record: RunRecord, numbers: dict, failed: int,
           attempted: int, device: dict, paused_s: float) -> tuple[dict, list[str]]:
    """(The result's line, the lines naming the window and each number compared with its limit).

    With ``trace`` the metrics are the cell's per-layer ones, else its
    end-to-end ones.  ``device`` is the result's ``device`` entry; a
    profiled record adds ``busy_s``, ``window_s`` and the ``breakdown``.
    """
    metrics = {}
    for m in registry.metrics(bench, cell["name"], trace):
        value = registry.module("metrics", m["name"]).read(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    out = {"correct": all(v <= lim for v, lim in numbers.values()), "attempted": attempted,
           "failed": failed, "metrics": metrics, "device": device}
    if record.trace is not None:
        device["busy_s"] = record.trace.busy_s()
        device["window_s"] = record.trace.window_s
        out["breakdown"] = breakdown(record.trace)
    out["checks"] = {name: {"value": v, "limit": lim} for name, (v, lim) in numbers.items()}
    lat = record.latencies_s
    ms = np.percentile(np.array(lat) * 1e3, [0, 50, 95, 100]) if lat else []
    lines = [f"latency ms min/median/p95/max: {' / '.join(f'{x:.3f}' for x in ms)}; "
             f"window {record.window_s:.3f} s, copies of the kept outputs {paused_s:.3f} s, "
             f"set-up {record.setup_s:.3f} s"]
    lines += [f"check {name}: {v} (limit {lim})" for name, (v, lim) in numbers.items()]
    return out, lines
