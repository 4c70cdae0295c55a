"""The one general generator of query streams: a traffic file's parameters, drawn from a seed.

A traffic file (``qbench/traffic/<mix>.json``) names its query and gives
each substitution parameter's values: ``{"range": [lo, hi]}`` (integers,
inclusive) or ``{"dates": [first, last]}`` (ISO days, inclusive, as
int32 days since 1970-01-01).  The stream runs through
every combination of the values, each pass in a seeded random order, so
every seed draws each combination equally often, and each parameter is
uniform over its values as TPC-H's query generator draws it.
"""

from __future__ import annotations

import itertools

import numpy as np

from qbench.gen.tpch import day


def values(spec: dict) -> list:
    """The values one parameter takes."""
    (kind, arg), = spec.items()
    if kind == "range":
        return list(range(arg[0], arg[1] + 1))
    if kind == "dates":
        return list(range(day(arg[0]), day(arg[1]) + 1))
    raise ValueError(f"unknown parameter kind {kind!r}")


def queries(traffic: dict, seed):
    """Endless parameter dicts of the traffic's query, from ``seed`` (as ``default_rng`` takes it)."""
    names = sorted(traffic["params"])
    combos = list(itertools.product(*(values(traffic["params"][n]) for n in names)))
    rng = np.random.default_rng(seed)
    while True:
        for i in rng.permutation(len(combos)):
            yield dict(zip(names, combos[i]))
