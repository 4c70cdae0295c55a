"""TPC-H Q18, large volume customer, as a plan over the port's public operators.

    select c_custkey, o_orderkey, o_orderdate, o_totalprice, sum(l_quantity)
    from customer, orders, lineitem
    where o_orderkey in (select l_orderkey from lineitem group by l_orderkey
                         having sum(l_quantity) > :quantity)
      and c_custkey = o_custkey and o_orderkey = l_orderkey
    group by c_custkey, o_orderkey, o_orderdate, o_totalprice
    order by o_totalprice desc, o_orderdate
    limit 100

(c_name is not held.)  The plan: the group-by of all of lineitem on
l_orderkey, the HAVING filter, the join of orders with the survivors (the
survivors build: fewer live rows), the join with customer (customer
builds: its key is unique, an order's customer key is not), and the
top-100 as two stable sorts, by o_orderdate and then by o_totalprice
descending.  Each operator's ``to_table()`` is the plan's host sync.  The
outer group-by of TPC-H's text is a no-op here: the survivors are unique
orders, and their sum of quantities rides the join.
"""

from __future__ import annotations

from gpuradixsort_tpu_torch.core.table import Column, Table
from gpuradixsort_tpu_torch.ops.aggregate import group_by_aggregate
from gpuradixsort_tpu_torch.ops.filter import filter_table
from gpuradixsort_tpu_torch.ops.join import join
from gpuradixsort_tpu_torch.ops.sort import sort_table

from qbench.probe import host_columns, row_bytes
from qbench.queries.common import INT32_MAX, as_key, head

TABLES = ("lineitem", "orders", "customer")
LIMIT = 100


def run(db: dict[str, Table], params: dict, probe) -> dict:
    """The answer's rows on the host, {column: array}."""
    li, o, c = db["lineitem"], db["orders"], db["customer"]

    lines = Table({"orderkey": li["l_orderkey"], "l_quantity": li["l_quantity"]})
    with probe.span("groupby"):
        groups = group_by_aggregate(lines, "orderkey",
                                    {"sum_qty": ("l_quantity", "sum")}).to_table()
    probe.sorted(lines.length)
    probe.keep("groupby", groups)

    with probe.span("filter"):
        big = filter_table(groups, lambda t: t["sum_qty"].data > params["quantity"]).to_table()
    probe.compacted(groups.length, big.length, row_bytes(groups))
    probe.keep("having", big)

    orders = Table({"orderkey": o["o_orderkey"], "custkey": o["o_custkey"],
                    "o_orderdate": o["o_orderdate"], "o_totalprice": o["o_totalprice"]})
    with probe.span("join"):
        hits = join(orders, big, "orderkey").to_table()
    probe.joined(orders, big, hits)
    probe.keep("join_orders", hits)

    customers = Table({"custkey": c["c_custkey"]})
    with probe.span("join"):
        rows = join(hits, customers, "custkey").to_table()
    probe.joined(hits, customers, rows)
    probe.keep("join_customer", rows)

    with probe.span("sort"):
        n = rows.length
        day_key = Column(as_key(rows["o_orderdate"].data), n)
        by_date = sort_table(rows.with_column("k", day_key), "k")
        price_desc = INT32_MAX - by_date["o_totalprice"].data
        top = sort_table(by_date.with_column("k", Column(as_key(price_desc), n)), "k")
        answer = host_columns(Table({
            name: head(top[column], LIMIT) for name, column in (
                ("o_custkey", "custkey"), ("o_orderkey", "orderkey"),
                ("o_orderdate", "o_orderdate"), ("o_totalprice", "o_totalprice"),
                ("sum_qty", "build_sum_qty"))}))
    probe.sorted(n)
    probe.sorted(n)
    return answer

