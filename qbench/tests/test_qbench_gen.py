"""The generator: the same tables from one seed, and TPC-H's value rules (clause 4.2.3)."""

from __future__ import annotations

import json

import numpy as np
import torch

from qbench import registry
from qbench.gen import tpch
from qbench.reference.common import host
from qbench.tests.conftest import SEED, TINY_SF


def _np(tables):
    return {name: host(cols) for name, cols in tables.items()}


def test_same_seed_same_tables_other_seed_other(tiny_tables):
    again = tpch.generate({"scale_factor": TINY_SF}, SEED, "cpu")
    other = tpch.generate({"scale_factor": TINY_SF}, SEED + 1, "cpu")
    for table, cols in tiny_tables.items():
        for name, col in cols.items():
            same = again[table][name]
            if col.dtype == torch.uint32:
                col, same = col.view(torch.int32), same.view(torch.int32)
            assert torch.equal(col, same), name
    assert not torch.equal(tiny_tables["orders"]["o_orderdate"], other["orders"]["o_orderdate"])


def test_sizes_and_dtypes(tiny_tables):
    n = tpch.sizes(TINY_SF)
    rows = {t: next(iter(cols.values())).shape[0] for t, cols in tiny_tables.items()}
    assert rows["orders"] == n["orders"] and rows["customer"] == n["customer"]
    assert rows["part"] == n["part"] and rows["supplier"] == n["supplier"]
    assert rows["partsupp"] == 4 * n["part"] and rows["nation"] == 25 and rows["region"] == 5
    assert n["orders"] <= rows["lineitem"] <= 7 * n["orders"]
    for table in tiny_tables.values():
        for name, col in table.items():
            assert col.shape[0] == next(iter(table.values())).shape[0], name
            if name.endswith("key"):
                assert col.dtype == torch.uint32 and col.dim() == 1, name
            elif name.split("_")[1] in ("comment", "address", "phone", "name") \
                    and col.dtype == torch.uint8:
                assert col.dim() == 2, name
            else:
                assert col.dim() == 1 and col.dtype in (torch.int32, torch.uint8), name


def test_every_column_of_the_schema(tiny_tables):
    """The eight tables hold every column of clause 1.4.1, text at its declared width."""
    with open(registry.HERE / "configs" / "tpch_sf30.json") as f:
        stated = json.load(f)["tables"]
    assert {t: list(cols) for t, cols in tiny_tables.items()} == \
        {t: list(spec["columns"]) for t, spec in stated.items()}
    for name, (_, _, width) in tpch.TEXT.items():
        table = next(t for t in tiny_tables.values() if name in t)
        assert table[name].shape[1] == width, name
        assert f"uint8[{width}]" in stated[[t for t in stated if name in stated[t]["columns"]][0]][
            "columns"][name]


def test_value_rules(tiny_tables):
    t = _np(tiny_tables)
    li, o, c = t["lineitem"], t["orders"], t["customer"]
    n = tpch.sizes(TINY_SF)

    okey = o["o_orderkey"].astype(np.int64)
    assert len(np.unique(okey)) == len(okey)
    assert np.all((okey - 1) % 32 < 8)  # sparse: the first 8 of every 32
    assert np.array_equal(np.sort(okey), tpch.order_key(torch.arange(len(okey))).numpy())

    cust = o["o_custkey"].astype(np.int64)
    assert cust.min() >= 1 and cust.max() <= n["customer"] and np.all(cust % 3 != 0)
    assert np.array_equal(np.sort(c["c_custkey"].astype(np.int64)), np.arange(1, n["customer"] + 1))
    assert set(np.unique(c["c_mktsegment"])) <= set(range(5))

    assert o["o_orderdate"].min() >= tpch.START_DATE
    assert o["o_orderdate"].max() <= tpch.END_DATE - 151
    assert np.all(o["o_shippriority"] == 0)

    per_order = np.bincount(li["l_orderkey"].astype(np.int64), minlength=okey.max() + 1)[okey]
    assert per_order.min() >= 1 and per_order.max() <= 7
    assert set(np.unique(per_order)) == set(range(1, 8))

    date_of = dict(zip(okey, o["o_orderdate"]))
    ship = li["l_shipdate"] - np.array([date_of[k] for k in li["l_orderkey"].astype(np.int64)])
    assert ship.min() >= 1 and ship.max() <= 121
    assert li["l_quantity"].min() >= 1 and li["l_quantity"].max() <= 50
    assert li["l_discount"].min() >= 0 and li["l_discount"].max() <= 10
    # l_extendedprice = quantity * p_retailprice of a part in 1..SF * 200,000.
    retail = li["l_extendedprice"] // li["l_quantity"]
    assert np.all(li["l_extendedprice"] % li["l_quantity"] == 0)
    parts = tpch.retail_price(torch.arange(1, n["part"] + 1)).numpy()
    assert np.isin(retail, parts).all()

    # o_totalprice: each lineitem's charge, with l_tax in [0, 0.08], rounded to the cent.
    net = li["l_extendedprice"].astype(np.int64) * (100 - li["l_discount"])
    low = np.bincount(li["l_orderkey"].astype(np.int64), weights=net / 100.0)[okey]
    high = np.bincount(li["l_orderkey"].astype(np.int64), weights=net * 1.08 / 100.0)[okey]
    assert np.all(o["o_totalprice"] >= np.floor(low) - 7)
    assert np.all(o["o_totalprice"] <= np.ceil(high) + 7)


def test_value_rules_of_the_other_columns(tiny_tables):
    t = _np(tiny_tables)
    li, o, c, p, s, ps = (t[n] for n in ("lineitem", "orders", "customer", "part", "supplier",
                                         "partsupp"))
    n = tpch.sizes(TINY_SF)
    # lineitem: linenumbers 1..count, supplier of the part, dates, flags.
    key = li["l_orderkey"].astype(np.int64)
    order = np.lexsort((li["l_linenumber"], key))
    first = np.r_[True, key[order][1:] != key[order][:-1]]
    run_start = np.maximum.accumulate(np.where(first, np.arange(len(key)), 0))
    assert np.array_equal(li["l_linenumber"][order], np.arange(len(key)) - run_start + 1)
    part = li["l_partkey"].astype(np.int64)
    supp = li["l_suppkey"].astype(np.int64)
    own = np.stack([tpch.supplier_of(torch.from_numpy(part), i, n["supplier"]).numpy()
                    for i in range(4)])
    assert np.all((own == supp).any(axis=0))
    date_of = dict(zip(o["o_orderkey"].astype(np.int64), o["o_orderdate"]))
    odate = np.array([date_of[k] for k in key])
    assert np.all((li["l_commitdate"] - odate >= 30) & (li["l_commitdate"] - odate <= 90))
    gap = li["l_receiptdate"] - li["l_shipdate"]
    assert gap.min() >= 1 and gap.max() <= 30
    assert li["l_tax"].min() >= 0 and li["l_tax"].max() <= 8
    late = li["l_receiptdate"] > tpch.CURRENT_DATE
    assert np.all(li["l_returnflag"][late] == ord("N"))
    assert set(np.unique(li["l_returnflag"][~late])) == {ord("R"), ord("A")}
    assert np.array_equal(li["l_linestatus"] == ord("O"), li["l_shipdate"] > tpch.CURRENT_DATE)
    assert set(np.unique(li["l_shipinstruct"])) == set(range(4))
    assert set(np.unique(li["l_shipmode"])) == set(range(7))
    # o_orderstatus from its lineitems' statuses.
    fs = {}
    for k, st in zip(key, li["l_linestatus"]):
        fs.setdefault(k, set()).add(chr(st))
    want = [{"F": "F", "O": "O"}.get("".join(fs[k]), "P") for k in o["o_orderkey"].astype(np.int64)]
    assert [chr(x) for x in o["o_orderstatus"]] == want
    assert set(np.unique(o["o_orderpriority"])) == set(range(5))
    assert o["o_clerk"].min() >= 1 and o["o_clerk"].max() <= round(TINY_SF * 1000)
    # customer and supplier: names from keys, phones from nations, balances.
    for tab, pre in ((c, "c"), (s, "s")):
        assert np.array_equal(tab[f"{pre}_name"], tab[f"{pre}_{'cust' if pre == 'c' else 'supp'}key"]
                              .astype(np.int32))
        phone = tab[f"{pre}_phone"]
        assert np.array_equal((phone[:, 0] - 48) * 10 + phone[:, 1] - 48,
                              tab[f"{pre}_nationkey"] + 10)
        assert np.all(phone[:, [2, 6, 10]] == ord("-"))
        assert tab[f"{pre}_acctbal"].min() >= -99999 and tab[f"{pre}_acctbal"].max() <= 999999
    # part: keys, price rule, five distinct name words, codes in range.
    assert np.array_equal(np.sort(p["p_partkey"].astype(np.int64)), np.arange(1, n["part"] + 1))
    assert np.array_equal(p["p_retailprice"],
                          tpch.retail_price(torch.from_numpy(p["p_partkey"].astype(np.int64))))
    words = np.sort(p["p_name"].astype(np.int64), axis=1)
    assert words.max() < tpch.NAME_WORDS and np.all(np.diff(words, axis=1) > 0)
    assert set(np.unique(p["p_brand"] // 10)) == set(p["p_mfgr"]) == set(range(1, 6))
    # partsupp: each part's 4 suppliers by the rule, all distinct.
    pairs = sorted(zip(ps["ps_partkey"].astype(np.int64), ps["ps_suppkey"].astype(np.int64)))
    want = sorted((k, int(tpch.supplier_of(torch.tensor(k), i, n["supplier"])))
                  for k in range(1, n["part"] + 1) for i in range(4))
    assert pairs == want and len(set(pairs)) == len(pairs)
    assert ps["ps_supplycost"].min() >= 100 and ps["ps_supplycost"].max() <= 100000
    # text: letters up to the drawn length, zero after, lengths in the stated range.
    for table in t.values():
        for name, col in table.items():
            if name in tpch.TEXT:
                lo, hi, _ = tpch.TEXT[name]
                length = (col != 0).sum(axis=1)
                assert length.min() >= lo and length.max() <= hi, name
                assert np.all((col != 0) == (np.arange(col.shape[1]) < length[:, None])), name


def test_rows_in_a_seeded_random_order(tiny_tables):
    key = tiny_tables["orders"]["o_orderkey"].view(torch.int32)
    assert not torch.equal(key, torch.sort(key).values)


def test_resident_bytes(tiny_tables):
    """Every column counts, at its declared width: 98 bytes a lineitem row, 108 an order."""
    rows = {t: next(iter(cols.values())).shape[0] for t, cols in tiny_tables.items()}
    width = {t: sum(c[0].numel() * c.element_size() for c in cols.values())
             for t, cols in tiny_tables.items()}
    assert width["lineitem"] == 98 and width["orders"] == 108 and width["customer"] == 192
    assert tpch.resident_bytes(tiny_tables) == sum(rows[t] * width[t] for t in rows)
