"""Each plain reference against a brute-force version: Python loops over numpy rows."""

from __future__ import annotations

from collections import defaultdict

import numpy as np
import pytest

from qbench.gen import tpch
from qbench.reference import q3, q18
from qbench.reference.common import host


def _np(tables):
    return {name: host(cols) for name, cols in tables.items()}


def _q18_brute(t, quantity):
    li, o, c = t["lineitem"], t["orders"], t["customer"]
    sums = defaultdict(int)
    for k, q in zip(li["l_orderkey"].tolist(), li["l_quantity"].tolist()):
        sums[k] += q
    known = set(c["c_custkey"].tolist())
    rows = [(ck, ok, od, tp, sums[ok]) for ok, ck, od, tp in zip(
        o["o_orderkey"].tolist(), o["o_custkey"].tolist(), o["o_orderdate"].tolist(),
        o["o_totalprice"].tolist()) if sums[ok] > quantity and ck in known]
    rows.sort(key=lambda r: (-r[3], r[2], r[1]))
    return rows, sums


def _q3_brute(t, segment, date):
    li, o, c = t["lineitem"], t["orders"], t["customer"]
    theirs = {k for k, s in zip(c["c_custkey"].tolist(), c["c_mktsegment"].tolist())
              if s == segment}
    order = {k: (d, p) for k, ck, d, p in zip(
        o["o_orderkey"].tolist(), o["o_custkey"].tolist(), o["o_orderdate"].tolist(),
        o["o_shippriority"].tolist()) if ck in theirs and d < date}
    total = defaultdict(float)
    for k, e, dc, s in zip(li["l_orderkey"].tolist(), li["l_extendedprice"].tolist(),
                           li["l_discount"].tolist(), li["l_shipdate"].tolist()):
        if s > date and k in order:
            total[k] += float(np.float32(e * (100 - dc) / 10000))
    rows = [(k, float(np.float32(v)), *order[k]) for k, v in total.items()]
    rows.sort(key=lambda r: (-r[1], r[2], r[0]))
    return rows


def _sorted_rows(answer, names, order_key):
    rows = list(zip(*(answer[n].tolist() for n in names)))
    return sorted(rows, key=order_key)


@pytest.mark.parametrize("quantity", [200, 240, 260])
def test_q18_answer_and_operators(tiny_tables, quantity):
    t = _np(tiny_tables)
    brute, sums = _q18_brute(t, quantity)
    assert brute, "the test's quantity must leave rows"
    ref = q18.Reference(tiny_tables)
    top, rows = ref.expect({"quantity": quantity})
    names = ("o_custkey", "o_orderkey", "o_orderdate", "o_totalprice", "sum_qty")
    key = lambda r: (-r[3], r[2], r[1])  # noqa: E731
    assert _sorted_rows(top, names, key) == brute[:q18.LIMIT]
    assert sorted(zip(*(rows[n].tolist() for n in names)), key=key) == brute
    assert np.all(np.diff(rows[q18.KEY].astype(np.int64)) > 0)

    ops = ref.operators({"quantity": quantity})
    keys = sorted(sums)
    assert ops["groupby"]["orderkey"].tolist() == keys
    assert ops["groupby"]["sum_qty"].tolist() == [sums[k] for k in keys]
    assert ops["having"]["orderkey"].tolist() == [k for k in keys if sums[k] > quantity]
    # The joins keep the orders table's order.
    o = t["orders"]
    hits = [i for i, k in enumerate(o["o_orderkey"].tolist()) if sums[k] > quantity]
    assert ops["join_orders"]["orderkey"].tolist() == o["o_orderkey"][hits].tolist()
    assert ops["join_orders"]["build_sum_qty"].tolist() == [sums[k] for k in o["o_orderkey"][hits]]
    assert ops["join_customer"]["orderkey"].tolist() == o["o_orderkey"][hits].tolist()


@pytest.mark.parametrize("segment,date", [(0, tpch.day("1995-03-01")),
                                          (3, tpch.day("1995-03-15")),
                                          (4, tpch.day("1995-03-31"))])
def test_q3_answer_and_operators(tiny_tables, segment, date):
    t = _np(tiny_tables)
    brute = _q3_brute(t, segment, date)
    ref = q3.Reference(tiny_tables)
    params = {"segment": segment, "date": date}
    top, rows = ref.expect(params)
    names = ("l_orderkey", "revenue", "o_orderdate", "o_shippriority")
    key = lambda r: (-r[1], r[2], r[0])  # noqa: E731
    assert _sorted_rows(top, names, key) == brute[:q3.LIMIT]
    assert sorted(zip(*(rows[n].tolist() for n in names)), key=key) == brute

    ops = ref.operators(params)
    li, o, c = t["lineitem"], t["orders"], t["customer"]
    assert ops["filter_customer"]["custkey"].tolist() == \
        c["c_custkey"][c["c_mktsegment"] == segment].tolist()
    early = o["o_orderdate"] < date
    assert ops["filter_orders"]["orderkey"].tolist() == o["o_orderkey"][early].tolist()
    theirs = set(ops["filter_customer"]["custkey"].tolist())
    semi = early & np.isin(o["o_custkey"], list(theirs))
    assert ops["semijoin_orders"]["orderkey"].tolist() == o["o_orderkey"][semi].tolist()
    late = li["l_shipdate"] > date
    assert ops["filter_lineitem"]["l_extendedprice"].tolist() == \
        li["l_extendedprice"][late].tolist()
    joined = late & np.isin(li["l_orderkey"], o["o_orderkey"][semi])
    assert ops["join_lineitem"]["orderkey"].tolist() == li["l_orderkey"][joined].tolist()
    assert ops["groupby"]["orderkey"].tolist() == sorted(r[0] for r in brute)


def test_controls_differ_from_the_references(tiny_tables):
    """A precision below the stated one changes what the references compute."""
    exact, low = q18.Reference(tiny_tables), q18.Reference(tiny_tables, low_precision=True)
    a = exact.operators({"quantity": 240})["groupby"]["sum_qty"]
    b = low.operators({"quantity": 240})["groupby"]["sum_qty"]
    assert np.any(a != b)
    params = {"segment": 1, "date": tpch.day("1995-03-15")}
    a = q3.Reference(tiny_tables).expect(params)[1]["revenue"]
    b = q3.Reference(tiny_tables, low_precision=True).expect(params)[1]["revenue"]
    assert np.max(np.abs(a.astype(np.float64) - b) / a) > q3.FLOAT_LIMIT
