"""Finds a cell's files by the names in ``BENCHMARK.json``.

A configuration is the ``file`` its entry names; its ``generator`` is
``qbench/gen/<generator>.py``.  A traffic mix is
``qbench/traffic/<traffic>.json``; the query it names has its plan in
``qbench/queries/<query>.py`` and its plain reference in
``qbench/reference/<query>.py``.  Each metric is read by
``qbench/metrics/<name>.py``.  A new configuration, mix or metric is new
files and entries; no file here changes.
"""

from __future__ import annotations

import importlib
import json
import pathlib

ROOT = pathlib.Path(__file__).resolve().parents[1]
HERE = pathlib.Path(__file__).resolve().parent


def benchmark() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def _named(entries: list, name: str, what: str) -> dict:
    for entry in entries:
        if entry["name"] == name:
            return entry
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def workload(bench: dict, name: str) -> dict:
    return _named(bench["workloads"], name, "workload")


def config(bench: dict, name: str) -> dict:
    with open(ROOT / _named(bench["configs"], name, "config")["file"]) as f:
        return json.load(f)


def traffic(name: str) -> dict:
    with open(HERE / "traffic" / f"{name}.json") as f:
        return json.load(f)


def module(kind: str, name: str):
    """``qbench/<kind>/<name>.py``: kind is gen, queries, reference or metrics."""
    return importlib.import_module(f"qbench.{kind}.{name}")


def metrics(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The cell's end-to-end metrics, or with ``trace`` its per-layer ones.

    A metric with a ``workloads`` key is the listed cells'; an end-to-end
    one without it is every cell's, a per-layer one every cell's that
    reports the end-to-end metric it moves.
    """
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    reported = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m else m["moves"] in reported)]
