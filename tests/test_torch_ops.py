"""The port's operators against the JAX package's, buffer for buffer.

Every case feeds the same seeded numpy columns to ``gpuradixsort_tpu``'s
filter / group-by aggregate / join on the CPU (its jnp reference kernels)
and to the port's, and requires the padded output buffers and the counts to
be equal.  Float sums and means are added in another order (the port sums
in float64 and rounds once, the JAX package takes a float32 tree), so they
are compared with ``rtol=FLOAT_RTOL``; every other output is exact.

The port's predicates are written on int32 views or int64-widened keys:
PyTorch has no comparison for uint32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpuradixsort_tpu.config import EngineConfig as JaxConfig
from gpuradixsort_tpu.core import table as jtable
from gpuradixsort_tpu.ops import aggregate as jagg
from gpuradixsort_tpu.ops import filter as jfilter
from gpuradixsort_tpu.ops import join as jjoin
from gpuradixsort_tpu.ops import sort as jsort
from gpuradixsort_tpu_torch.config import EngineConfig
from gpuradixsort_tpu_torch.core import table as ttable
from gpuradixsort_tpu_torch.core.table import int32_bits
from gpuradixsort_tpu_torch.kernels import radix as tradix
from gpuradixsort_tpu_torch.kernels import scan as tscan
from gpuradixsort_tpu_torch.ops import aggregate as tagg
from gpuradixsort_tpu_torch.ops import filter as tfilter
from gpuradixsort_tpu_torch.ops import join as tjoin
from gpuradixsort_tpu_torch.ops import sort as tsort
from gpuradixsort_tpu_torch.ops.permute import scatter_by_destination
from gpuradixsort_tpu_torch.parallel.launch import run_ops, run_ranks

torch.set_num_threads(1)

CFG = EngineConfig()
JCFG = JaxConfig()
FLOAT_RTOL = 1e-5  # float32 sums taken in another order
AGGS = {
    "total": ("val", "sum"),
    "cnt": ("val", "count"),
    "lo": ("val", "min"),
    "hi": ("val", "max"),
    "avg": ("val", "mean"),
}


def _tables(key_name, keys, **cols):
    """The same columns as a JAX table and as the port's table."""
    jt = jtable.table_from_arrays(JCFG, **cols)
    jt = jt.with_column(key_name, jtable.make_key_column(keys, JCFG))
    return jt, ttable.table_from_jax(jt, device="cpu")


def _wide(t: torch.Tensor) -> torch.Tensor:
    return int32_bits(t).to(torch.int64) & 0xFFFFFFFF


def _same_table(got, want, floats=()):
    """Equal names, live lengths and padded buffers; ``floats`` within FLOAT_RTOL."""
    assert got.names() == want.names()
    for name in want.names():
        g, w = got[name], want[name]
        assert g.length == w.length, name
        if name in floats:
            np.testing.assert_allclose(g.data.numpy(), np.asarray(w.data), rtol=FLOAT_RTOL,
                                       err_msg=name)
        else:
            assert g.data.dtype == getattr(torch, str(np.asarray(w.data).dtype)), name
            np.testing.assert_array_equal(g.data.numpy(), np.asarray(w.data), err_msg=name)


def _same_selection(got, want, floats=()):
    assert int(got.count) == int(want.count)
    assert got.count.dtype == torch.int32 and got.count.dim() == 0
    _same_table(got.table, want.table, floats)
    _same_table(got.to_table(), want.to_table(), floats)


@pytest.mark.parametrize("n", [16, 1000, 4096, 5000])
def test_filter_matches_jax(n, rng):
    keys = rng.integers(0, 1000, n, dtype=np.uint32)
    vals = rng.integers(-100, 100, n).astype(np.int32)
    jt, tt = _tables("key", keys, val=vals)
    want = jfilter.filter_table(jt, lambda t: t["key"].data < 300, JCFG)
    got = tfilter.filter_table(tt, lambda t: _wide(t["key"].data) < 300, CFG)
    _same_selection(got, want)
    out = got.to_table()
    np.testing.assert_array_equal(out["key"].to_numpy(), keys[keys < 300])
    np.testing.assert_array_equal(out["val"].to_numpy(), vals[keys < 300])


def test_filter_none_and_all(rng):
    keys = rng.integers(0, 1000, 1000, dtype=np.uint32)
    jt, tt = _tables("key", keys, val=rng.integers(-100, 100, 1000).astype(np.int32))
    none = tfilter.filter_table(tt, lambda t: torch.zeros(t["key"].padded_length, dtype=torch.bool),
                                CFG)
    _same_selection(none, jfilter.filter_table(jt, lambda t: t["key"].data < 0, JCFG))
    assert none.to_table().length == 0
    alln = tfilter.filter_table(tt, lambda t: torch.ones(t["key"].padded_length, dtype=torch.bool),
                                CFG)
    jall = jfilter.filter_table(jt, lambda t: jnp.ones_like(t["key"].data, jnp.bool_), JCFG)
    _same_selection(alln, jall)
    np.testing.assert_array_equal(alln.to_table()["key"].to_numpy(), keys)


def test_filter_then_sort(rng):
    keys = rng.integers(0, 1 << 16, 3000, dtype=np.uint32)
    jt, tt = _tables("key", keys, val=rng.integers(-100, 100, 3000).astype(np.int32))
    jsel = jfilter.filter_table(jt, lambda t: (t["key"].data & 1) == 0, JCFG)
    sel = tfilter.filter_table(tt, lambda t: (int32_bits(t["key"].data) & 1) == 0, CFG)
    _same_selection(sel, jsel)
    want = jsort.sort_table(jsel.to_table(), "key", JCFG, method="radix")
    for method in ("auto", "fused", "radix"):
        got = tsort.sort_table(sel.to_table(), "key", CFG, method=method)
        _same_table(got, want)
    np.testing.assert_array_equal(got["key"].to_numpy(), np.sort(keys[keys % 2 == 0]))


def test_filter_mask_forms(rng):
    # A 0/1 integer mask selects as the boolean one does; a mask of another
    # shape than the padded rows is refused.
    keys = rng.integers(0, 1000, 700, dtype=np.uint32)
    _, tt = _tables("key", keys, val=np.arange(700, dtype=np.int32))
    pred = lambda t: _wide(t["key"].data) < 500  # noqa: E731
    base = tfilter.filter_table(tt, pred, CFG)
    as_int = tfilter.filter_table(tt, lambda t: pred(t).to(torch.int32), CFG)
    _same_table(as_int.table, base.table)
    assert int(as_int.count) == int(base.count) == int((keys < 500).sum())
    with pytest.raises(ValueError, match="predicate mask has shape"):
        tfilter.filter_table(tt, lambda t: torch.ones(10, dtype=torch.bool), CFG)


@pytest.mark.parametrize("n", [1000, 5000])
def test_filter_of_nine_columns_matches_jax(n, rng):
    # The key and eight payload columns, two of them 2-D: more than one
    # dest_scatter launch takes on the card.
    keys = rng.integers(0, 1000, n, dtype=np.uint32)
    cols = {
        "rows4": rng.integers(-(2**31), 2**31, (n, 4)).astype(np.int32),
        "f": rng.standard_normal(n).astype(np.float32),
        "u": rng.integers(0, 2**32, n, dtype=np.uint32),
        "h": rng.integers(-(2**15), 2**15, n).astype(np.int16),
        "flag": rng.integers(0, 2, n).astype(bool),
        "bytes5": rng.integers(0, 256, (n, 5)).astype(np.uint8),
        "v": rng.integers(-100, 100, n).astype(np.int32),
        "g": rng.standard_normal(n).astype(np.float32),
    }
    jt, tt = _tables("key", keys, **cols)
    assert len(tt.names()) == 9
    want = jfilter.filter_table(jt, lambda t: t["key"].data < 300, JCFG)
    got = tfilter.filter_table(tt, lambda t: _wide(t["key"].data) < 300, CFG)
    _same_selection(got, want)
    out = got.to_table()
    for name, c in cols.items():
        np.testing.assert_array_equal(out[name].to_numpy(), c[keys < 300], err_msg=name)


@pytest.mark.parametrize("path", ["radix pass", "compaction"])
def test_radix_pass_and_compaction_move_rows_by_dest_scatter(path, rng, monkeypatch):
    # Each pass of the radix method and each compaction is one dest_scatter
    # call with every moved column; neither calls tile_destinations or the
    # plain scatter itself.
    calls = []
    real = tradix.dest_scatter

    def spy(rank_keys, hist, offsets, shift, cfg, values, **kwargs):
        calls.append((shift, len(values)))
        return real(rank_keys, hist, offsets, shift, cfg, values, **kwargs)

    def refuse(*args, **kwargs):
        raise AssertionError("not on an operator path")

    monkeypatch.setattr(tradix, "dest_scatter", spy)
    monkeypatch.setattr(tradix, "tile_destinations", refuse)
    monkeypatch.setattr(tfilter, "scatter_by_destination", refuse, raising=False)
    monkeypatch.setattr(tsort, "scatter_by_destination", refuse, raising=False)
    keys = rng.integers(0, 1000, 3000, dtype=np.uint32)
    if path == "radix pass":
        s, p = tsort.sort_pairs(keys, CFG, method="radix", device="cpu")
        np.testing.assert_array_equal(p.to_numpy(), np.argsort(keys, kind="stable"))
        assert calls == [(4 * i, 2) for i in range(CFG.num_passes)]
    else:
        _, tt = _tables("key", keys, val=np.arange(3000, dtype=np.int32),
                        rows=rng.integers(0, 9, (3000, 2)).astype(np.int32))
        sel = tfilter.filter_table(tt, lambda t: _wide(t["key"].data) < 300, CFG).to_table()
        np.testing.assert_array_equal(sel["val"].to_numpy(), np.flatnonzero(keys < 300))
        assert calls == [(0, 3)]


def test_scatter_by_destination_moves_2d_rows(rng):
    dest = torch.from_numpy(rng.permutation(64).astype(np.int32))
    rows = torch.from_numpy(rng.integers(0, 2**32, (64, 3), dtype=np.uint32))
    floats = torch.from_numpy(rng.standard_normal(64).astype(np.float32))
    out_rows, out_floats = scatter_by_destination(dest, [rows, floats])
    want = np.empty_like(rows.numpy())
    want[dest.numpy()] = rows.numpy()
    np.testing.assert_array_equal(out_rows.numpy(), want)
    assert out_rows.dtype == torch.uint32
    np.testing.assert_array_equal(out_floats.numpy()[dest.numpy()], floats.numpy())


@pytest.mark.parametrize("n,groups", [(1000, 10), (5000, 257), (4096, 1)])
def test_group_by_aggregate_matches_jax(n, groups, rng):
    keys = rng.integers(0, groups, n, dtype=np.uint32)
    vals = rng.integers(-100, 100, n).astype(np.int32)
    jt, tt = _tables("key", keys, val=vals)
    want = jagg.group_by_aggregate(jt, "key", AGGS, JCFG)
    got = tagg.group_by_aggregate(tt, "key", AGGS, CFG)
    _same_selection(got, want, floats=("avg",))
    out = got.to_table()
    uniq, inverse, counts = np.unique(keys, return_inverse=True, return_counts=True)
    np.testing.assert_array_equal(out["key"].to_numpy(), uniq)
    np.testing.assert_array_equal(out["cnt"].to_numpy(), counts)
    np.testing.assert_array_equal(out["total"].to_numpy(), np.bincount(inverse, vals))
    np.testing.assert_allclose(out["avg"].to_numpy(), np.bincount(inverse, vals) / counts,
                               rtol=FLOAT_RTOL)


def test_aggregate_int32_wraparound(rng):
    n = 100_000
    keys = rng.integers(0, 50, n, dtype=np.uint32)
    vals = rng.integers(-(2**31), 2**31 - 1, n).astype(np.int32)
    jt, tt = _tables("k", keys, v=vals)
    want = jagg.group_by_aggregate(jt, "k", {"s": ("v", "sum")}, JCFG)
    got = tagg.group_by_aggregate(tt, "k", {"s": ("v", "sum")}, CFG)
    _same_selection(got, want)
    expect = np.array([vals[keys == g].sum(dtype=np.int32) for g in np.unique(keys)], np.int32)
    np.testing.assert_array_equal(got.to_table()["s"].to_numpy(), expect)


def test_aggregate_float32_at_1m(rng):
    n = 1_000_000
    keys = rng.integers(0, 1000, n, dtype=np.uint32)
    vals = (rng.random(n).astype(np.float32) * 1e6).astype(np.float32)
    aggs = {"s": ("v", "sum"), "m": ("v", "mean")}
    jt, tt = _tables("k", keys, v=vals)
    want = jagg.group_by_aggregate(jt, "k", aggs, JCFG)
    got = tagg.group_by_aggregate(tt, "k", aggs, CFG)
    _same_selection(got, want, floats=("s", "m"))
    _, inverse, counts = np.unique(keys, return_inverse=True, return_counts=True)
    sums = np.bincount(inverse, vals.astype(np.float64))
    out = got.to_table()
    np.testing.assert_allclose(out["s"].to_numpy().astype(np.float64), sums, rtol=FLOAT_RTOL)
    np.testing.assert_allclose(out["m"].to_numpy().astype(np.float64), sums / counts,
                               rtol=FLOAT_RTOL)


def test_aggregate_mean_of_large_ints(rng):
    n = 10_000
    keys = rng.integers(0, 8, n, dtype=np.uint32)
    vals = rng.integers(0, 2**30, n).astype(np.int32)
    jt, tt = _tables("k", keys, v=vals)
    want = jagg.group_by_aggregate(jt, "k", {"m": ("v", "mean")}, JCFG)
    got = tagg.group_by_aggregate(tt, "k", {"m": ("v", "mean")}, CFG)
    _same_selection(got, want, floats=("m",))
    expect = np.array([vals[keys == g].mean() for g in np.unique(keys)])
    np.testing.assert_allclose(got.to_table()["m"].to_numpy(), expect, rtol=FLOAT_RTOL)


def test_aggregate_uint32_payload_min_max_sum(rng):
    n = 3000
    keys = rng.integers(0, 40, n, dtype=np.uint32)
    vals = rng.integers(0, 2**32, n, dtype=np.uint32)  # top bit set in half the rows
    aggs = {"lo": ("v", "min"), "hi": ("v", "max"), "s": ("v", "sum")}
    jt, tt = _tables("k", keys, v=vals)
    want = jagg.group_by_aggregate(jt, "k", aggs, JCFG)
    got = tagg.group_by_aggregate(tt, "k", aggs, CFG)
    _same_selection(got, want)
    out = got.to_table()
    assert out["lo"].dtype == torch.uint32
    for i, g in enumerate(np.unique(keys)):
        assert out["lo"].to_numpy()[i] == vals[keys == g].min()
        assert out["hi"].to_numpy()[i] == vals[keys == g].max()


def test_aggregate_float_min_max(rng):
    n = 2000
    keys = rng.integers(0, 30, n, dtype=np.uint32)
    vals = rng.standard_normal(n).astype(np.float32)
    aggs = {"lo": ("v", "min"), "hi": ("v", "max"), "c": ("v", "count")}
    jt, tt = _tables("k", keys, v=vals)
    _same_selection(tagg.group_by_aggregate(tt, "k", aggs, CFG),
                    jagg.group_by_aggregate(jt, "k", aggs, JCFG))


def test_aggregate_live_keys_equal_to_pad_key(rng):
    # A live key equal to the pad key runs on into the pads, and the JAX
    # package drops that group; the port must give the same buffers.
    keys = rng.integers(0, 5, 900, dtype=np.uint32)
    keys[::7] = 0xFFFFFFFF
    jt, tt = _tables("k", keys, v=rng.integers(-9, 9, 900).astype(np.int32))
    aggs = {"s": ("v", "sum"), "c": ("v", "count")}
    _same_selection(tagg.group_by_aggregate(tt, "k", aggs, CFG),
                    jagg.group_by_aggregate(jt, "k", aggs, JCFG))


@pytest.mark.parametrize("live_as_tensor", [False, True])
def test_aggregate_sorted_flat_matches_jax(live_as_tensor, rng):
    n, padded = 2500, 2 * CFG.block
    keys = np.full(padded, 0xFFFFFFFF, dtype=np.uint32)
    keys[:n] = np.sort(rng.integers(0, 300, n, dtype=np.uint32))
    vals = rng.integers(-1000, 1000, padded).astype(np.int32)
    kinds = ("sum", "count", "min", "max", "mean")
    jinputs = [(k, None if k == "count" else jnp.asarray(vals), k) for k in kinds]
    tinputs = [(k, None if k == "count" else torch.from_numpy(vals), k) for k in kinds]
    n_live = torch.tensor(n, dtype=torch.int32) if live_as_tensor else n
    jkeys, jout, jcount = jagg.aggregate_sorted_flat(jnp.asarray(keys), n, jinputs, JCFG)
    tkeys, tout, tcount = tagg.aggregate_sorted_flat(torch.from_numpy(keys), n_live, tinputs)
    assert int(tcount) == int(jcount) == np.unique(keys[:n]).size
    np.testing.assert_array_equal(tkeys.numpy(), np.asarray(jkeys))
    for k in kinds:
        if k == "mean":
            np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]), rtol=FLOAT_RTOL)
        else:
            np.testing.assert_array_equal(tout[k].numpy(), np.asarray(jout[k]), err_msg=k)


def test_aggregate_rejects_bad_specs(rng):
    _, tt = _tables("k", np.arange(10, dtype=np.uint32), v=np.arange(10, dtype=np.int32))
    with pytest.raises(ValueError, match="unsupported aggregation"):
        tagg.group_by_aggregate(tt, "k", {"x": ("v", "median")}, CFG)
    with pytest.raises(KeyError, match="not in table"):
        tagg.group_by_aggregate(tt, "k", {"x": ("w", "sum")}, CFG)


def _join_tables(rng, nb=500, n_probe=3000):
    build_keys = rng.permutation(10_000)[:nb].astype(np.uint32)  # unique
    build_payload = rng.integers(0, 1 << 30, nb).astype(np.int32)
    probe_keys = rng.integers(0, 10_000, n_probe, dtype=np.uint32)
    probe_payload = rng.integers(0, 1 << 30, n_probe).astype(np.int32)
    jb, tb = _tables("key", build_keys, payload=build_payload)
    jp, tp = _tables("key", probe_keys, pval=probe_payload)
    return jb, tb, jp, tp


@pytest.mark.parametrize("how", ["inner", "semi", "anti"])
def test_join_matches_jax(how, rng):
    jb, tb, jp, tp = _join_tables(rng)
    want = jjoin.join(jp, jb, "key", how, JCFG, validate_unique=True)
    got = tjoin.join(tp, tb, "key", how, CFG, validate_unique=True)
    _same_selection(got, want)
    probe_keys, build_keys = tp["key"].to_numpy(), tb["key"].to_numpy()
    hit = np.isin(probe_keys, build_keys)
    expect = probe_keys[~hit] if how == "anti" else probe_keys[hit]
    np.testing.assert_array_equal(got.to_table()["key"].to_numpy(), expect)


def test_join_rejects_duplicates_and_unknown_types():
    keys = np.array([5, 5, 7], dtype=np.uint32)
    _, tb = _tables("key", keys, payload=np.arange(3, dtype=np.int32))
    _, tp = _tables("key", np.array([5, 6, 7, 8], dtype=np.uint32),
                    pval=np.arange(4, dtype=np.int32))
    with pytest.raises(ValueError, match="duplicate"):
        tjoin.join(tp, tb, "key", "inner", CFG, validate_unique=True)
    with pytest.raises(ValueError, match="unknown join type"):
        tjoin.join(tp, tb, "key", "outer", CFG)


def test_join_empty_build(rng):
    jb, tb = _tables("key", np.zeros(0, dtype=np.uint32), payload=np.zeros(0, dtype=np.int32))
    _, tp = _tables("key", rng.integers(0, 9, 50, dtype=np.uint32),
                    pval=np.arange(50, dtype=np.int32))
    assert tjoin.join(tp, tb, "key", "inner", CFG).to_table().length == 0
    assert tjoin.join(tp, tb, "key", "anti", CFG).to_table().length == 50


def _expand_oracle(pk, pv, bk, bv):
    """(probe key, probe payload, build payload) for every match, in output order."""
    order = np.argsort(bk, kind="stable")
    bk_s, bv_s = bk[order], bv[order]
    rows = []
    for i in range(len(pk)):
        lo, hi = np.searchsorted(bk_s, pk[i], "left"), np.searchsorted(bk_s, pk[i], "right")
        rows += [(int(pk[i]), int(pv[i]), int(bv_s[j])) for j in range(lo, hi)]
    return rows


def test_join_expand_duplicates_and_misses(rng):
    pk = rng.integers(0, 50, 500, dtype=np.uint32)
    bk = rng.integers(0, 50, 300, dtype=np.uint32)  # heavy duplicates; some keys missing
    pv = rng.integers(0, 2**31, 500).astype(np.int32)
    bv = rng.integers(0, 2**31, 300).astype(np.int32)
    jp, tp = _tables("k", pk, pv=pv)
    jb, tb = _tables("k", bk, bv=bv)
    expect = _expand_oracle(pk, pv, bk, bv)
    want = jjoin.join_expand(jp, jb, "k", JCFG, capacity=len(expect) + 100)
    got = tjoin.join_expand(tp, tb, "k", CFG, capacity=len(expect) + 100)
    assert not bool(got.overflow) and got.overflow.dtype == torch.bool
    assert int(got.count) == int(want.count) == len(expect)
    _same_table(got.table, want.table)
    out = got.to_table()
    rows = list(zip(out["k"].to_numpy().tolist(), out["pv"].to_numpy().tolist(),
                    out["build_bv"].to_numpy().tolist()))
    assert rows == expect


def test_join_expand_overflow_flag():
    pk = bk = np.full(200, 7, dtype=np.uint32)  # 200 * 200 matches
    jp, tp = _tables("k", pk)
    jb, tb = _tables("k", bk)
    want = jjoin.join_expand(jp, jb, "k", JCFG, capacity=1000)
    got = tjoin.join_expand(tp, tb, "k", CFG, capacity=1000)
    assert bool(got.overflow) and bool(want.overflow)
    assert int(got.count) == int(want.count) == 200 * 200
    _same_table(got.table, want.table)
    with pytest.raises(RuntimeError, match="capacity"):
        got.to_table()


def test_join_expand_unique_build_matches_join(rng):
    bk = rng.permutation(1000)[:100].astype(np.uint32)  # unique
    pk = rng.choice(np.concatenate([bk, np.arange(2000, 2100, dtype=np.uint32)]), 400)
    bv = rng.integers(0, 2**31, 100).astype(np.int32)
    jp, tp = _tables("k", pk.astype(np.uint32))
    jb, tb = _tables("k", bk, bv=bv)
    got = tjoin.join_expand(tp, tb, "k", CFG)  # default capacity: the probe's padded length
    _same_table(got.table, jjoin.join_expand(jp, jb, "k", JCFG).table)
    inner = tjoin.join(tp, tb, "k", how="inner", cfg=CFG).to_table()
    out = got.to_table()
    np.testing.assert_array_equal(out["k"].to_numpy(), inner["k"].to_numpy())
    np.testing.assert_array_equal(out["build_bv"].to_numpy(), inner["build_bv"].to_numpy())


def _wrapped(n: int) -> int:
    """n as the int32 it wraps to."""
    return (n + 2**31) % 2**32 - 2**31


@pytest.mark.parametrize("rows", [65_536, 46_341])
def test_join_expand_overflows_past_2_31_matches(rows):
    # One key on both sides: rows * rows matches (2^32, and 2,147,488,281
    # just past 2^31), whose int32 total wraps.  The JAX package compares the
    # wrapped total and reports no overflow, so the port is held to the true
    # count alone: overflow, and to_table() raises.
    keys = np.full(rows, 7, dtype=np.uint32)
    probe = ttable.Table({"k": ttable.make_key_column(keys, CFG, device="cpu")})
    build = ttable.table_from_arrays(CFG, device="cpu", v=np.arange(rows, dtype=np.int32))
    build = build.with_column("k", ttable.make_key_column(keys, CFG, device="cpu"))
    got = tjoin.join_expand(probe, build, "k", CFG)
    assert got.overflow.dtype == torch.bool and bool(got.overflow)
    assert got.count.dtype == torch.int32 and got.count.dim() == 0
    assert int(got.count) == _wrapped(rows * rows)  # the scan's total, wrapped
    with pytest.raises(RuntimeError, match="capacity"):
        got.to_table()


def test_matches_exceed_sums_in_int64():
    # The check join_expand and the distributed join share: 65,536 rows of
    # 65,536 matches wrap K5's int32 total to 0, and still exceed any capacity.
    cnt = torch.full((65_536,), 65_536, dtype=torch.int32)
    assert int(tscan.exclusive_scan(cnt)[1]) == 0
    for capacity in (2**20, 2**31, 2**40):  # capacities past 2^31 - 1 count as 2^31 - 1
        assert bool(tjoin.matches_exceed(cnt, capacity))
    most = torch.tensor([2**31 - 1], dtype=torch.int32)
    assert not bool(tjoin.matches_exceed(most, 2**40))
    assert bool(tjoin.matches_exceed(torch.cat([most, torch.ones(1, dtype=torch.int32)]), 2**40))
    assert not bool(tjoin.matches_exceed(torch.tensor([3, 4], dtype=torch.int32), 7))
    assert bool(tjoin.matches_exceed(torch.tensor([3, 5], dtype=torch.int32), 7))


def test_dist_join_cut_counts_matches_past_2_31():
    # One gloo rank: every row stays on its shard, so the exchange cannot
    # overflow and only the join's own cut can see the 2^32 matches of one
    # key (65,536 probe x 65,536 build rows), whose int32 total wraps to 0.
    n = 65_536
    keys = np.full(n, 7, dtype=np.uint32)
    vals = np.arange(n, dtype=np.int32)
    calls = [{"op": "join", "inputs": {"probe_keys": keys, "probe_values": vals,
                                       "build_keys": keys, "build_values": vals},
              "kwargs": {"cfg": CFG, "auto_retry": False}, "gather": True}]
    (result,), = run_ranks(1, run_ops, (calls,), device="cpu", timeout=120.0)
    assert result["overflow"]
    assert "overflowed" in result["gather_error"]
