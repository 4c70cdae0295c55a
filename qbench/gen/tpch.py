"""TPC-H base tables, every column of all eight, made on the device from a seed by dbgen's rules.

TPC-H revision 3.0.1: the columns and their widths of clause 1.4.1, the
values of clause 4.2.3.  Every column is drawn by ``torch.randint`` (or
``torch.rand``) from one ``torch.Generator`` on the tables' device, in a
fixed order and in a few large calls, so one seed gives the same tables on
one device, and a second call of ``generate`` gives the reference the
tables the program was given.  The rows of each table are put in a
seeded random order; a column whose values are drawn for each row alone
(the comments, the codes of a row's own choice) is drawn in that order
directly, which gives it the same law.

Representations (the port has no decimals and no strings): keys uint32;
dates int32 days since 1970-01-01; money int32 cents; discounts and taxes
int32 hundredths; a char(1) flag its one byte (uint8); a string drawn from
a fixed list an int32 code of it (``p_name``, five words of a list, five
uint8 codes); a string made from a number (``Customer#000000001``) that int32
number; free text and phones uint8 bytes at the column's declared width,
the text's length drawn as dbgen draws it and the rest zero.  Free text is
random lowercase letters, not dbgen's grammar of words: no query here
reads it.  The tables are exact-length tensors; padding them is the
program's business.
"""

from __future__ import annotations

import datetime

import torch

_EPOCH = datetime.date(1970, 1, 1)


def day(iso: str) -> int:
    """Days since 1970-01-01 of an ISO date."""
    return (datetime.date.fromisoformat(iso) - _EPOCH).days


START_DATE = day("1992-01-01")
END_DATE = day("1998-12-31")
CURRENT_DATE = day("1995-06-17")
# An order's date leaves room for its lineitems' ship, receipt and return dates.
LAST_ORDER_DATE = END_DATE - 151
SEGMENTS = ("AUTOMOBILE", "BUILDING", "FURNITURE", "HOUSEHOLD", "MACHINERY")
PRIORITIES = ("1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW")
INSTRUCTIONS = ("DELIVER IN PERSON", "COLLECT COD", "NONE", "TAKE BACK RETURN")
MODES = ("REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB")
TYPES = 6 * 5 * 5  # p_type: one syllable of each of three lists
CONTAINERS = 5 * 8  # p_container: one syllable of each of two lists
NAME_WORDS = 92  # p_name: five distinct words of this list
# n_regionkey of each nation (clause 4.2.3), by n_nationkey.
NATION_REGION = (0, 1, 1, 1, 4, 0, 3, 3, 2, 2, 4, 4, 2, 4, 0, 0, 0, 1, 2, 3, 4, 2, 3, 3, 1)
REGIONS = 5
# Free text: (least, most) characters drawn, and the declared width (clause 1.4.1).
TEXT = {
    "p_comment": (5, 22, 23), "s_address": (10, 40, 40), "s_comment": (25, 100, 101),
    "ps_comment": (49, 198, 199), "c_address": (10, 40, 40), "c_comment": (29, 116, 117),
    "o_comment": (19, 78, 79), "l_comment": (10, 43, 44), "n_comment": (31, 114, 152),
    "r_comment": (31, 115, 152),
}
PHONE_WIDTH = 15
# Rows of text drawn by one call, so that a wide column's temporaries stay small.
TEXT_ROWS = 1 << 22


def sizes(scale_factor: float) -> dict[str, int]:
    """Rows of orders, customer, part and supplier at a scale factor."""
    return {"orders": round(scale_factor * 1_500_000), "customer": round(scale_factor * 150_000),
            "part": round(scale_factor * 200_000), "supplier": round(scale_factor * 10_000)}


def order_key(i: torch.Tensor) -> torch.Tensor:
    """dbgen's sparse key of the i-th order (from 0): the first 8 of every 32 keys."""
    return (i // 8) * 32 + i % 8 + 1


def retail_price(partkey: torch.Tensor) -> torch.Tensor:
    """p_retailprice in cents (clause 4.2.3): 90000 + (key / 10) mod 20001 + 100 (key mod 1000)."""
    return 90000 + (partkey // 10) % 20001 + 100 * (partkey % 1000)


def supplier_of(partkey: torch.Tensor, i, suppliers: int) -> torch.Tensor:
    """The i-th (0 to 3) supplier of a part (clause 4.2.3, PS_SUPPKEY)."""
    return (partkey + i * (suppliers // 4 + (partkey - 1) // suppliers)) % suppliers + 1


class _Draw:
    """The generator's draws, in the order they are called, on one device."""

    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self.g = torch.Generator(device=self.device)
        self.g.manual_seed(seed)

    def ints(self, lo: int, hi: int, n: int, dtype=torch.int32) -> torch.Tensor:
        """n values uniform over lo..hi inclusive."""
        return torch.randint(lo, hi + 1, (n,), generator=self.g, device=self.device, dtype=dtype)

    def order(self, n: int) -> torch.Tensor:
        return torch.randperm(n, generator=self.g, device=self.device)

    def text(self, name: str, n: int) -> torch.Tensor:
        """n rows of a free-text column: random lowercase letters, zero after the drawn length."""
        lo, hi, width = TEXT[name]
        out = torch.empty((n, width), dtype=torch.uint8, device=self.device)
        at = torch.arange(width, device=self.device, dtype=torch.int16)
        for start in range(0, n, TEXT_ROWS):
            rows = min(TEXT_ROWS, n - start)
            block = out[start:start + rows]
            block.random_(ord("a"), ord("z") + 1, generator=self.g)
            length = self.ints(lo, hi, rows, torch.int16)
            block.masked_fill_(at >= length[:, None], 0)
        return out

    def phones(self, nationkey: torch.Tensor) -> torch.Tensor:
        """``CC-DDD-DDD-DDDD`` with CC = nationkey + 10 (clause 4.2.2.9), as 15 bytes a row."""
        digits = torch.empty((nationkey.shape[0], PHONE_WIDTH), dtype=torch.uint8,
                             device=self.device).random_(ord("0"), ord("9") + 1, generator=self.g)
        digits[:, 0] = (nationkey + 10) // 10 + ord("0")
        digits[:, 1] = (nationkey + 10) % 10 + ord("0")
        digits[:, [2, 6, 10]] = ord("-")
        return digits


def _take(col: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    # PyTorch indexes no uint32 tensor on the CPU: move the int32 bits.
    if col.dtype == torch.uint32:
        return col.view(torch.int32)[rows].view(torch.uint32)
    return col[rows]


def _shuffled(d: _Draw, columns: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """The columns' rows in one seeded random order; each original is let go once moved."""
    order = d.order(next(iter(columns.values())).shape[0])
    return {name: _take(columns.pop(name), order) for name in list(columns)}


def _key(values: torch.Tensor) -> torch.Tensor:
    return values.to(torch.int32).view(torch.uint32)


def _part(d: _Draw, n: dict) -> dict[str, torch.Tensor]:
    rows = n["part"]
    partkey = d.order(rows).to(torch.int32) + 1
    mfgr = d.ints(1, 5, rows)
    words = torch.empty((rows, 5), dtype=torch.uint8, device=d.device)
    for start in range(0, rows, TEXT_ROWS):
        m = min(TEXT_ROWS, rows - start)
        noise = torch.rand((m, NAME_WORDS), generator=d.g, device=d.device)
        words[start:start + m] = noise.topk(5, dim=1).indices.to(torch.uint8)
    return {
        "p_partkey": _key(partkey), "p_name": words, "p_mfgr": mfgr,
        "p_brand": mfgr * 10 + d.ints(1, 5, rows), "p_type": d.ints(0, TYPES - 1, rows),
        "p_size": d.ints(1, 50, rows), "p_container": d.ints(0, CONTAINERS - 1, rows),
        "p_retailprice": retail_price(partkey), "p_comment": d.text("p_comment", rows),
    }


def _supplier(d: _Draw, n: dict) -> dict[str, torch.Tensor]:
    rows = n["supplier"]
    suppkey = d.order(rows).to(torch.int32) + 1
    nation = d.ints(0, 24, rows)
    return {
        "s_suppkey": _key(suppkey), "s_name": suppkey, "s_address": d.text("s_address", rows),
        "s_nationkey": _key(nation), "s_phone": d.phones(nation),
        "s_acctbal": d.ints(-99999, 999999, rows), "s_comment": d.text("s_comment", rows),
    }


def _partsupp(d: _Draw, n: dict) -> dict[str, torch.Tensor]:
    parts, suppliers = n["part"], n["supplier"]
    partkey = torch.arange(1, parts + 1, device=d.device, dtype=torch.int64).repeat_interleave(4)
    i = torch.arange(4, device=d.device, dtype=torch.int64).repeat(parts)
    cols = _shuffled(d, {"ps_partkey": _key(partkey),
                         "ps_suppkey": _key(supplier_of(partkey, i, suppliers))})
    rows = 4 * parts
    return {**cols, "ps_availqty": d.ints(1, 9999, rows),
            "ps_supplycost": d.ints(100, 100000, rows), "ps_comment": d.text("ps_comment", rows)}


def _customer(d: _Draw, n: dict) -> dict[str, torch.Tensor]:
    rows = n["customer"]
    custkey = d.order(rows).to(torch.int32) + 1
    nation = d.ints(0, 24, rows)
    return {
        "c_custkey": _key(custkey), "c_name": custkey, "c_address": d.text("c_address", rows),
        "c_nationkey": _key(nation), "c_phone": d.phones(nation),
        "c_acctbal": d.ints(-99999, 999999, rows),
        "c_mktsegment": d.ints(0, len(SEGMENTS) - 1, rows), "c_comment": d.text("c_comment", rows),
    }


def _orders_lineitem(d: _Draw, n: dict, scale_factor: float):
    n_orders, n_cust = n["orders"], n["customer"]
    order_idx = torch.arange(n_orders, device=d.device)
    o_orderkey = order_key(order_idx).to(torch.int32)
    # The k-th (from 0) custkey that is no multiple of 3 is k + k // 2 + 1.
    k = d.ints(0, 2 * n_cust // 3 - 1, n_orders)
    o_custkey = k + k // 2 + 1
    o_orderdate = d.ints(START_DATE, LAST_ORDER_DATE, n_orders)
    lines = d.ints(1, 7, n_orders)

    owner = torch.repeat_interleave(order_idx, lines)  # each lineitem's order
    n_lines = owner.shape[0]
    first = torch.cumsum(lines, 0) - lines  # each order's first lineitem
    l_linenumber = (torch.arange(n_lines, device=d.device) - first[owner] + 1).to(torch.int32)
    l_quantity = d.ints(1, 50, n_lines)
    l_partkey = d.ints(1, n["part"], n_lines)
    l_suppkey = supplier_of(l_partkey.long(), d.ints(0, 3, n_lines).long(), n["supplier"])
    l_extendedprice = l_quantity * retail_price(l_partkey)
    l_discount = d.ints(0, 10, n_lines)
    l_tax = d.ints(0, 8, n_lines)
    l_shipdate = o_orderdate[owner] + d.ints(1, 121, n_lines)
    l_commitdate = o_orderdate[owner] + d.ints(30, 90, n_lines)
    l_receiptdate = l_shipdate + d.ints(1, 30, n_lines)
    returned = ord("A") + (ord("R") - ord("A")) * d.ints(0, 1, n_lines)  # R or A
    l_returnflag = torch.where(l_receiptdate <= CURRENT_DATE, returned, ord("N")).to(torch.uint8)
    del returned
    shipped = (l_shipdate <= CURRENT_DATE).to(torch.int32)
    l_linestatus = (ord("O") - (ord("O") - ord("F")) * shipped).to(torch.uint8)  # F or O

    # Cents a lineitem, rounded half up; at most 7 * 11,335,000 cents an order.
    charge = (l_extendedprice.to(torch.int64) * (100 - l_discount) * (100 + l_tax) + 5000) // 10000
    o_totalprice = torch.zeros(n_orders, dtype=torch.int64, device=d.device)
    o_totalprice.index_add_(0, owner, charge)
    del charge
    # F where every lineitem has shipped, O where none has, P otherwise.
    done = torch.zeros(n_orders, dtype=torch.int32, device=d.device)
    done.index_add_(0, owner, shipped)
    o_orderstatus = torch.full((n_orders,), ord("P"), dtype=torch.uint8, device=d.device)
    o_orderstatus[done == 0] = ord("O")
    o_orderstatus[done == lines] = ord("F")
    del done, shipped

    lineitem = _shuffled(d, {
        "l_orderkey": o_orderkey[owner].view(torch.uint32), "l_partkey": _key(l_partkey),
        "l_suppkey": _key(l_suppkey), "l_linenumber": l_linenumber, "l_quantity": l_quantity,
        "l_extendedprice": l_extendedprice, "l_discount": l_discount, "l_tax": l_tax,
        "l_returnflag": l_returnflag, "l_linestatus": l_linestatus, "l_shipdate": l_shipdate,
        "l_commitdate": l_commitdate, "l_receiptdate": l_receiptdate,
    })
    del owner, first, l_linenumber, l_quantity, l_partkey, l_suppkey, l_extendedprice
    del l_discount, l_tax, l_shipdate, l_commitdate, l_receiptdate, l_returnflag, l_linestatus
    lineitem["l_shipinstruct"] = d.ints(0, len(INSTRUCTIONS) - 1, n_lines)
    lineitem["l_shipmode"] = d.ints(0, len(MODES) - 1, n_lines)
    lineitem["l_comment"] = d.text("l_comment", n_lines)

    orders = _shuffled(d, {
        "o_orderkey": o_orderkey.view(torch.uint32), "o_custkey": o_custkey.view(torch.uint32),
        "o_orderstatus": o_orderstatus, "o_totalprice": o_totalprice.to(torch.int32),
        "o_orderdate": o_orderdate,
    })
    orders["o_orderpriority"] = d.ints(0, len(PRIORITIES) - 1, n_orders)
    orders["o_clerk"] = d.ints(1, max(round(scale_factor * 1000), 1), n_orders)
    orders["o_shippriority"] = torch.zeros(n_orders, dtype=torch.int32, device=d.device)
    orders["o_comment"] = d.text("o_comment", n_orders)
    return orders, lineitem


def _nation_region(d: _Draw) -> tuple[dict, dict]:
    nations = len(NATION_REGION)
    nationkey = torch.arange(nations, dtype=torch.int32, device=d.device)
    regionkey = torch.arange(REGIONS, dtype=torch.int32, device=d.device)
    nation = {"n_nationkey": _key(nationkey), "n_name": nationkey,
              "n_regionkey": _key(torch.tensor(NATION_REGION, device=d.device)),
              "n_comment": d.text("n_comment", nations)}
    region = {"r_regionkey": _key(regionkey), "r_name": regionkey,
              "r_comment": d.text("r_comment", REGIONS)}
    return nation, region


def generate(config: dict, seed: int, device) -> dict[str, dict[str, torch.Tensor]]:
    """The configuration's eight tables, {table: {column: tensor}}, from ``seed`` on ``device``."""
    d = _Draw(seed, device)
    n = sizes(config["scale_factor"])
    part = _part(d, n)
    supplier = _supplier(d, n)
    partsupp = _partsupp(d, n)
    customer = _customer(d, n)
    orders, lineitem = _orders_lineitem(d, n, config["scale_factor"])
    nation, region = _nation_region(d)
    return {"lineitem": lineitem, "orders": orders, "customer": customer, "part": part,
            "supplier": supplier, "partsupp": partsupp, "nation": nation, "region": region}


def resident_bytes(tables: dict[str, dict[str, torch.Tensor]]) -> int:
    """Bytes of every column of the tables, live rows only."""
    return sum(col.numel() * col.element_size()
               for table in tables.values() for col in table.values())
