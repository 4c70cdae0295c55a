"""Plain reference of TPC-H Q18 and of each operator of its plan.

Plain PyTorch on the tables' device, by direct addressing instead of
sorting: the sum of quantities of every order key by ``index_add_`` over
an array the size of the key range, the survivors by a mask, each join by
a lookup in an array indexed by key.  Rows come out in the order the
plan's stable operators keep: groups by key, joined rows in the probe's
order.

``low_precision`` is the control: the sums accumulated in bfloat16 in
place of exact integers, which breaks the configuration's guarantee that
integer sums are exact.
"""

from __future__ import annotations

import numpy as np
import torch

from qbench.reference.common import host, pick, wide

ORDER = (("o_totalprice", "desc"), ("o_orderdate", "asc"))
KEY = "o_orderkey"
LIMIT = 100
FLOAT_LIMIT = None  # no float column: every number is compared exactly
GAP_NAME = None


class Reference:
    """Q18's sums by order key on ``tables``, then each query's answer and operator outputs."""

    def __init__(self, tables: dict, low_precision: bool = False):
        li, o = tables["lineitem"], tables["orders"]
        self.orders = o
        key = wide(li["l_orderkey"])
        size = int(wide(o["o_orderkey"]).max()) + 1
        dev = key.device
        self.lines = torch.zeros(size, dtype=torch.int64, device=dev).index_add_(
            0, key, torch.ones_like(key))
        if low_precision:
            acc = torch.zeros(size, dtype=torch.bfloat16, device=dev)
            self.qty = acc.index_add_(0, key, li["l_quantity"].to(torch.bfloat16)).long()
        else:
            self.qty = torch.zeros(size, dtype=torch.int64, device=dev).index_add_(
                0, key, li["l_quantity"].long())
        cust = wide(tables["customer"]["c_custkey"])
        self.known_customer = torch.zeros(int(cust.max()) + 1, dtype=torch.bool, device=dev)
        self.known_customer[cust] = True

    def _joined(self, quantity: int) -> dict[str, torch.Tensor]:
        """Orders, in table order, whose lineitems' quantities sum above ``quantity``."""
        o = self.orders
        okey = wide(o["o_orderkey"])
        hit = torch.nonzero(self.qty[okey] > quantity).flatten()
        return {"orderkey": pick(o["o_orderkey"], hit), "custkey": pick(o["o_custkey"], hit),
                "o_orderdate": o["o_orderdate"][hit], "o_totalprice": o["o_totalprice"][hit],
                "build_sum_qty": self.qty[okey[hit]].to(torch.int32)}

    def _with_customer(self, joined: dict) -> dict[str, torch.Tensor]:
        known = torch.nonzero(self.known_customer[wide(joined["custkey"])]).flatten()
        return {name: pick(t, known) for name, t in joined.items()}

    def operators(self, params: dict) -> dict[str, dict[str, np.ndarray]]:
        """Every operator's whole output, named and ordered as the plan keeps it."""
        keys = torch.nonzero(self.lines > 0).flatten()
        groups = {"orderkey": keys.to(torch.int32).view(torch.uint32),
                  "sum_qty": self.qty[keys].to(torch.int32)}
        big = torch.nonzero(groups["sum_qty"] > params["quantity"]).flatten()
        joined = self._joined(params["quantity"])
        return {"groupby": host(groups),
                "having": host({name: pick(t, big) for name, t in groups.items()}),
                "join_orders": host(joined),
                "join_customer": host(self._with_customer(joined))}

    def expect(self, params: dict) -> tuple[dict, dict]:
        """(The top 100 rows, by o_totalprice descending, then o_orderdate; every row, by key)."""
        j = host(self._with_customer(self._joined(params["quantity"])))
        rows = {"o_custkey": j["custkey"], "o_orderkey": j["orderkey"],
                "o_orderdate": j["o_orderdate"], "o_totalprice": j["o_totalprice"],
                "sum_qty": j["build_sum_qty"]}
        by_key = np.argsort(rows[KEY], kind="stable")
        order = np.lexsort((rows["o_orderdate"], -rows["o_totalprice"].astype(np.int64)))[:LIMIT]
        return ({name: a[order] for name, a in rows.items()},
                {name: a[by_key] for name, a in rows.items()})
