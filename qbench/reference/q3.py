"""Plain reference of TPC-H Q3 and of each operator of its plan.

Plain PyTorch on the tables' device, by direct addressing instead of
sorting: each order's segment and date looked up in arrays indexed by
key, each group's revenue by ``index_add_`` in float64 over an array the
size of the key range, rounded to float32 once.  Rows come out in the
order the plan's stable operators keep: filtered and joined rows in their
table's order, groups by key.

A lineitem's revenue is l_extendedprice * (1 - l_discount) in float32
dollars, and a group's revenue their sum in float64, rounded to float32
once, as the configuration states.  ``low_precision`` is the control: the
sum accumulated in float32, the precision below the stated float64.
"""

from __future__ import annotations

import numpy as np
import torch

from qbench.reference.common import by_key, host, pick, wide

ORDER = (("revenue", "desc"), ("o_orderdate", "asc"))
KEY = "l_orderkey"
LIMIT = 10
# The widest relative gap of a revenue; set from the readings in PERF.md.
FLOAT_LIMIT = 1e-7
GAP_NAME = "revenue_rel_gap"


class Reference:
    """Q3's lookups by key on ``tables``, then each query's answer and operator outputs."""

    def __init__(self, tables: dict, low_precision: bool = False):
        self.li, self.o, self.c = tables["lineitem"], tables["orders"], tables["customer"]
        size = int(wide(self.o["o_orderkey"]).max()) + 1
        self.row_of_order = by_key(self.o["o_orderkey"], size)
        self.order_of_line = self.row_of_order[wide(self.li["l_orderkey"])]
        custkey = wide(self.c["c_custkey"])
        self.segment_of = torch.full((int(custkey.max()) + 1,), -1, dtype=torch.int32,
                                     device=custkey.device)
        self.segment_of[custkey] = self.c["c_mktsegment"]
        self.revenue = (self.li["l_extendedprice"].double()
                        * (100 - self.li["l_discount"]).double() / 10000).float()
        self.sum_dtype = torch.float32 if low_precision else torch.float64

    def _order_ok(self, params: dict) -> torch.Tensor:
        """Per order row: placed before the date by a customer of the segment."""
        return (self.o["o_orderdate"] < params["date"]) \
            & (self.segment_of[wide(self.o["o_custkey"])] == params["segment"])

    def _line_ok(self, params: dict) -> torch.Tensor:
        """Per lineitem row: shipped after the date, of an order that qualifies."""
        return (self.li["l_shipdate"] > params["date"]) & self._order_ok(params)[self.order_of_line]

    def _groups(self, params: dict) -> dict[str, torch.Tensor]:
        keep = torch.nonzero(self._line_ok(params)).flatten()
        key = wide(self.li["l_orderkey"])[keep]
        size = self.row_of_order.shape[0]
        total = torch.zeros(size, dtype=self.sum_dtype, device=key.device).index_add_(
            0, key, self.revenue[keep].to(self.sum_dtype))
        seen = torch.zeros(size, dtype=torch.bool, device=key.device)
        seen[key] = True
        keys = torch.nonzero(seen).flatten()
        row = self.row_of_order[keys]
        return {"orderkey": keys.to(torch.int32).view(torch.uint32),
                "revenue": total[keys].float(), "o_orderdate": self.o["o_orderdate"][row],
                "o_shippriority": self.o["o_shippriority"][row]}

    def operators(self, params: dict) -> dict[str, dict[str, np.ndarray]]:
        """Every operator's whole output, named and ordered as the plan keeps it."""
        li, o, c = self.li, self.o, self.c
        cust = torch.nonzero(c["c_mktsegment"] == params["segment"]).flatten()
        early = torch.nonzero(o["o_orderdate"] < params["date"]).flatten()
        theirs = torch.nonzero(self._order_ok(params)).flatten()
        late = torch.nonzero(li["l_shipdate"] > params["date"]).flatten()
        joined = torch.nonzero(self._line_ok(params)).flatten()

        def orders(rows):
            return {"orderkey": pick(o["o_orderkey"], rows), "custkey": pick(o["o_custkey"], rows),
                    "o_orderdate": o["o_orderdate"][rows],
                    "o_shippriority": o["o_shippriority"][rows]}

        def lines(rows):
            return {"orderkey": pick(li["l_orderkey"], rows),
                    "l_extendedprice": li["l_extendedprice"][rows],
                    "l_discount": li["l_discount"][rows]}

        order_row = self.row_of_order[wide(li["l_orderkey"])[joined]]
        return {"filter_customer": host({"custkey": pick(c["c_custkey"], cust)}),
                "filter_orders": host(orders(early)),
                "semijoin_orders": host(orders(theirs)),
                "filter_lineitem": host(lines(late)),
                "join_lineitem": host({**lines(joined),
                                       "build_o_orderdate": o["o_orderdate"][order_row],
                                       "build_o_shippriority": o["o_shippriority"][order_row]}),
                "groupby": host(self._groups(params))}

    def expect(self, params: dict) -> tuple[dict, dict]:
        """(The top 10 groups, by revenue descending, then o_orderdate; every group, by key)."""
        g = host(self._groups(params))
        rows = {"l_orderkey": g["orderkey"], "revenue": g["revenue"],
                "o_orderdate": g["o_orderdate"], "o_shippriority": g["o_shippriority"]}
        order = np.lexsort((rows["o_orderdate"], -rows["revenue"].astype(np.float64)))[:LIMIT]
        return {name: a[order] for name, a in rows.items()}, rows
