"""Each cell's run end to end on the CPU at a tiny scale: sound, broken and the control.

``run_cell`` is a run without the look for a card: the same tables,
warm-up, closed-loop window, kept operator outputs and comparison.  A
sound port must come out correct; the control (the reference a precision
below the stated one, in the port's place) and each fault a query cell can
have (half of the rows left out; an answer altered where it is produced)
must come out not correct.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from gpuradixsort_tpu_torch.core.table import Column, Table
from qbench import registry, run
from qbench.control import Control
from qbench.queries import q3, q18
from qbench.tests.conftest import SEED

CELLS = ("tpch_sf30.q18", "tpch_sf30.q3")
PLANS = {"tpch_sf30.q18": q18, "tpch_sf30.q3": q3}


def _run(bench, name, **kw):
    result, lines = run.run_cell(bench, registry.workload(bench, name), SEED, 1.0, False, "cpu",
                                 **kw)
    return result, lines


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(tiny_bench, name):
    result, lines = _run(tiny_bench, name)
    assert result["correct"], lines
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert list(result)[-1] == "checks"
    assert all(c["value"] <= c["limit"] for c in result["checks"].values())
    assert {"rows_per_s", "query_p95_ms", "setup_s"} <= set(result["metrics"])


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(tiny_bench, name):
    result, lines = _run(tiny_bench, name, system=Control)
    assert not result["correct"], lines


def _half_rows(fn):
    """An operator that leaves out the second half of its input's rows."""
    def broken(table, *args, **kwargs):
        half = Table({n: Column(c.data, c.length // 2) for n, c in table.columns.items()})
        return fn(half, *args, **kwargs)
    return broken


def _altered(fn):
    """``host_columns`` with the first row's last column changed where the answer is made."""
    def broken(table):
        out = fn(table)
        name = list(out)[-1]
        if len(out[name]):
            out[name] = out[name].copy()
            out[name][0] = out[name][0] + np.asarray(1, dtype=out[name].dtype)
        return out
    return broken


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", ["half_of_the_rows", "answer_altered"])
def test_faults_are_not_correct(tiny_bench, monkeypatch, name, fault):
    plan = PLANS[name]
    if fault == "half_of_the_rows":
        monkeypatch.setattr(plan, "group_by_aggregate", _half_rows(plan.group_by_aggregate))
    else:
        monkeypatch.setattr(plan, "host_columns", _altered(plan.host_columns))
    result, lines = _run(tiny_bench, name)
    assert not result["correct"], lines
    assert result["failed"] > 0


def test_the_window_drives_the_public_operators(tiny_bench, monkeypatch):
    """Every query of the window goes through the port's operators, once each as planned."""
    calls = {"group_by_aggregate": 0, "join": 0, "filter_table": 0, "sort_table": 0}

    def counted(name, fn):
        def wrapper(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapper

    for name in calls:
        monkeypatch.setattr(q3, name, counted(name, getattr(q3, name)))
    result, _ = _run(tiny_bench, "tpch_sf30.q3")
    queries = result["attempted"] + 3  # with the warm-up's
    assert calls == {"group_by_aggregate": queries, "join": 2 * queries,
                     "filter_table": 3 * queries, "sort_table": 2 * queries}


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_sound_run_on_the_card(tiny_bench, card, name):
    result, lines = run.run_cell(tiny_bench, registry.workload(tiny_bench, name), SEED, 1.0, True,
                                 card)
    assert result["correct"], lines
    assert result["device"]["platform"] == "gpu" and result["device"]["busy_s"] > 0
    assert torch.cuda.max_memory_allocated(card) > 0
