"""The comparison that decides ``correct``: the program's rows against the reference's.

Integer columns must be equal.  A float column's gap is |program -
reference| / |reference|, and a row whose gap passes the query's float
limit is wrong.  An answer is checked row by row against every row the
reference admits (by key), and its order against the reference's own
top rows; so rows that tie on the ORDER BY may come in either order.
An operator's output is checked whole, row for row in its order.
"""

from __future__ import annotations

import numpy as np


def _gap(program: np.ndarray, reference: np.ndarray) -> np.ndarray:
    p, r = program.astype(np.float64), reference.astype(np.float64)
    return np.abs(p - r) / np.maximum(np.abs(r), np.finfo(np.float64).tiny)


def _differs(program: np.ndarray, reference: np.ndarray, limit: float) -> tuple[np.ndarray, float]:
    """Per row: whether the values differ beyond the limit; and the widest float gap."""
    if np.issubdtype(reference.dtype, np.floating):
        gap = _gap(program, reference)
        gap = np.where(np.isnan(gap), np.inf, gap)
        return gap > limit, float(gap.max(initial=0.0))
    return program.astype(np.int64) != reference.astype(np.int64), 0.0


def compare_table(program: dict, reference: dict, limit: float) -> tuple[int, float]:
    """(Rows wrong, widest float gap) of a whole operator output, in order.

    A column the program lacks makes every reference row wrong; a length
    that differs counts its difference.
    """
    if set(program) != set(reference):
        return max(len(next(iter(reference.values()), [])), 1), 0.0
    n_p, n_r = len(next(iter(program.values()))), len(next(iter(reference.values())))
    m = min(n_p, n_r)
    wrong = np.zeros(m, dtype=bool)
    widest = 0.0
    for name, ref in reference.items():
        bad, gap = _differs(program[name][:m], ref[:m], limit)
        wrong |= bad
        widest = max(widest, gap)
    return int(wrong.sum()) + abs(n_p - n_r), widest


def compare_answer(program: dict, top: dict, rows: dict, key: str, order, limit: float
                   ) -> tuple[int, float]:
    """(Rows wrong, widest float gap) of one query's answer.

    ``top``: the reference's answer in its order; ``rows``: every row the
    reference admits, sorted by ``key``.  A program row is wrong where its
    key is not admitted or repeats, where a column differs from the
    reference's row of that key, or where its ORDER BY values differ from
    those at its place in ``top``; a secondary ORDER BY column is not
    compared where an earlier float column ties within the limit.
    """
    if set(program) != set(top):
        return max(len(top[key]), 1), 0.0
    n_p, n_r = len(program[key]), len(top[key])
    keys = program[key].astype(np.int64)
    admitted = rows[key].astype(np.int64)
    at = np.clip(np.searchsorted(admitted, keys), 0, max(len(admitted) - 1, 0))
    wrong = np.ones(n_p, dtype=bool) if len(admitted) == 0 else admitted[at] != keys
    _, first = np.unique(keys, return_index=True)
    repeated = np.ones(n_p, dtype=bool)
    repeated[first] = False
    wrong |= repeated
    widest = 0.0
    if len(admitted):
        for name, ref in rows.items():
            bad, gap = _differs(program[name], ref[at], limit)
            wrong |= bad
            widest = max(widest, gap)
    m = min(n_p, n_r)
    tied = np.zeros(m, dtype=bool)
    for name, _ in order:
        ref = top[name][:m]
        if not tied.all():
            bad, _ = _differs(program[name][:m], ref, limit)
            wrong[:m] |= bad & ~tied
        if np.issubdtype(ref.dtype, np.floating) and m > 1:
            near = ~_differs(ref[1:], ref[:-1], limit)[0]
            tied[1:] |= near
            tied[:-1] |= near
    return int(wrong[:m].sum()) + abs(n_p - n_r), widest
