"""TPC-H Q3, shipping priority, as a plan over the port's public operators.

    select l_orderkey, sum(l_extendedprice * (1 - l_discount)) as revenue,
           o_orderdate, o_shippriority
    from customer, orders, lineitem
    where c_mktsegment = :segment and c_custkey = o_custkey
      and l_orderkey = o_orderkey
      and o_orderdate < :date and l_shipdate > :date
    group by l_orderkey, o_orderdate, o_shippriority
    order by revenue desc, o_orderdate
    limit 10

The plan: the three filters (each projects the columns the later
operators read; the predicate reads its own column), a semi join of the
surviving orders to the surviving customers (customers build: fewer live
rows), an inner join of the surviving lineitems to those orders (orders
build), which carries o_orderdate and o_shippriority, the revenue a row in
float32 dollars, the group-by on l_orderkey (o_orderdate and
o_shippriority depend on it: their min is their value), and the top-10
as two stable sorts, by o_orderdate and then by revenue descending.  Each
operator's ``to_table()`` is the plan's host sync.
"""

from __future__ import annotations

import torch

from gpuradixsort_tpu_torch.core.table import Column, Table
from gpuradixsort_tpu_torch.ops.aggregate import group_by_aggregate
from gpuradixsort_tpu_torch.ops.filter import filter_table
from gpuradixsort_tpu_torch.ops.join import join
from gpuradixsort_tpu_torch.ops.sort import sort_table

from qbench.probe import host_columns, row_bytes
from qbench.queries.common import INT32_MAX, as_key, head

TABLES = ("lineitem", "orders", "customer")
LIMIT = 10


def revenue(extendedprice: torch.Tensor, discount: torch.Tensor) -> torch.Tensor:
    """l_extendedprice * (1 - l_discount) in float32 dollars, from cents and hundredths."""
    return (extendedprice.double() * (100 - discount).double() / 10000).float()


def run(db: dict[str, Table], params: dict, probe) -> dict:
    """The answer's rows on the host, {column: array}."""
    li, o, c = db["lineitem"], db["orders"], db["customer"]
    segment, date = params["segment"], params["date"]

    customers = Table({"custkey": c["c_custkey"]})
    with probe.span("filter"):
        cust = filter_table(customers, lambda t: c["c_mktsegment"].data == segment).to_table()
    probe.compacted(customers.length, cust.length, row_bytes(customers))
    probe.keep("filter_customer", cust)

    orders = Table({"orderkey": o["o_orderkey"], "custkey": o["o_custkey"],
                    "o_orderdate": o["o_orderdate"], "o_shippriority": o["o_shippriority"]})
    with probe.span("filter"):
        early = filter_table(orders, lambda t: t["o_orderdate"].data < date).to_table()
    probe.compacted(orders.length, early.length, row_bytes(orders))
    probe.keep("filter_orders", early)

    with probe.span("join"):
        theirs = join(early, cust, "custkey", how="semi").to_table()
    probe.joined(early, cust, theirs)
    probe.keep("semijoin_orders", theirs)

    lines = Table({"orderkey": li["l_orderkey"], "l_extendedprice": li["l_extendedprice"],
                   "l_discount": li["l_discount"]})
    with probe.span("filter"):
        late = filter_table(lines, lambda t: li["l_shipdate"].data > date).to_table()
    probe.compacted(lines.length, late.length, row_bytes(lines))
    probe.keep("filter_lineitem", late)

    build = Table({"orderkey": theirs["orderkey"], "o_orderdate": theirs["o_orderdate"],
                   "o_shippriority": theirs["o_shippriority"]})
    with probe.span("join"):
        joined = join(late, build, "orderkey").to_table()
    probe.joined(late, build, joined)
    probe.keep("join_lineitem", joined)

    n = joined.length
    rows = Table({"orderkey": joined["orderkey"],
                  "revenue": Column(revenue(joined["l_extendedprice"].data,
                                            joined["l_discount"].data), n),
                  "o_orderdate": joined["build_o_orderdate"],
                  "o_shippriority": joined["build_o_shippriority"]})
    with probe.span("groupby"):
        groups = group_by_aggregate(rows, "orderkey", {
            "revenue": ("revenue", "sum"), "o_orderdate": ("o_orderdate", "min"),
            "o_shippriority": ("o_shippriority", "min")}).to_table()
    probe.sorted(n)
    probe.keep("groupby", groups)

    with probe.span("sort"):
        g = groups.length
        day_key = Column(as_key(groups["o_orderdate"].data), g)
        by_date = sort_table(groups.with_column("k", day_key), "k")
        # Positive float32 values order as their int32 bits.
        revenue_desc = INT32_MAX - by_date["revenue"].data.view(torch.int32)
        top = sort_table(by_date.with_column("k", Column(as_key(revenue_desc), g)), "k")
        answer = host_columns(Table({name: head(top[name], LIMIT) for name in
                                     ("orderkey", "revenue", "o_orderdate", "o_shippriority")}))
    probe.sorted(g)
    probe.sorted(g)
    return {"l_orderkey": answer.pop("orderkey"), **answer}

