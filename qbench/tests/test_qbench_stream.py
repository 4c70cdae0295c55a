"""The query streams: every combination once a pass, in a seeded order; TPC-H's ranges."""

from __future__ import annotations

import itertools

from qbench import registry, stream
from qbench.gen import tpch


def _take(mix, seed, n):
    return [tuple(sorted(p.items())) for p in itertools.islice(stream.queries(mix, seed), n)]


def test_each_pass_is_every_combination_once():
    mix = registry.traffic("q3")
    n = 5 * 31
    first = _take(mix, [2**31 + 5, 0], 2 * n)
    assert len(set(first[:n])) == n and set(first[:n]) == set(first[n:])
    assert _take(mix, [2**31 + 5, 0], 2 * n) == first
    other = _take(mix, [2**31 + 6, 0], n)
    assert set(other) == set(first[:n]) and other != first[:n]


def test_parameters_follow_tpch():
    q18 = {p["quantity"] for p in itertools.islice(stream.queries(registry.traffic("q18"), 1), 8)}
    assert q18 == {312, 313, 314, 315}  # clause 2.4.18.3
    q3 = list(itertools.islice(stream.queries(registry.traffic("q3"), 1), 155))
    assert {p["segment"] for p in q3} == set(range(len(tpch.SEGMENTS)))  # clause 2.4.3.3
    assert {p["date"] for p in q3} == set(range(tpch.day("1995-03-01"), tpch.day("1995-03-31") + 1))
