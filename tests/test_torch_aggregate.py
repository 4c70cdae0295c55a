"""The port's ``segment_aggregate`` against the JAX package's aggregate step.

The same seeded numpy buffers go through
``gpuradixsort_tpu/ops/aggregate.py::aggregate_sorted_flat`` on the CPU (its
segmented ``associative_scan`` and the compaction by its jnp reference
kernels) and through the port's ``segment_aggregate(impl="reference")``
(the kernel's plain version) and ``aggregate_sorted_flat``, which on the
CPU takes the same plain version.  Keys, counts, integer sums (wrapping),
min and max must be equal; float sums and means within ``FLOAT_RTOL``: the
JAX package sums float32 values in a float32 tree, the port in float64,
rounded once.  Columns hold values far from a cancellation, which a
float32 tree cannot carry to rtol 1e-5; float columns also hold NaNs, which
every float aggregate of their group must return.

One padded length (one block of the default config) serves every case, so
the JAX package compiles its compaction once a dtype.

With ``rows`` the port reads unsorted columns through the sort's
permutation; the JAX package is fed the same columns gathered by its own
``sort_table`` (or, where the rows are not a sort's, by its ``gather_rows``
with the same clamp).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpuradixsort_tpu.config import EngineConfig as JaxConfig
from gpuradixsort_tpu.core import table as jtable
from gpuradixsort_tpu.ops import aggregate as jagg
from gpuradixsort_tpu.ops import permute as jpermute
from gpuradixsort_tpu.ops import sort as jsort
from gpuradixsort_tpu_torch.kernels import aggregate as tkagg
from gpuradixsort_tpu_torch.ops import aggregate as tagg

torch.set_num_threads(1)

JCFG = JaxConfig()
PADDED = JCFG.block
PAD_KEY = 0xFFFFFFFF
FLOAT_RTOL = 1e-5  # float32 sums taken in another order
KINDS = ("sum", "count", "min", "max", "mean")
N_LIVE = PADDED - 1237  # a ragged live prefix


def _keys(pattern: str, rng) -> np.ndarray:
    """PADDED sorted keys with live rows first: the rows past N_LIVE are pads."""
    n = N_LIVE
    if pattern == "random":
        live = rng.integers(0, 700, n, dtype=np.uint32)
    elif pattern == "all_equal":
        live = np.full(n, 0x12345678, dtype=np.uint32)
    elif pattern == "all_unique":
        live = (np.arange(n, dtype=np.uint32) * 4099 + rng.integers(0, 4099)).astype(np.uint32)
    elif pattern == "pad_run":  # the last live run is the pad key, and runs on into the pads
        live = rng.integers(0, 300, n, dtype=np.uint32)
        live[rng.random(n) < 0.2] = PAD_KEY
    else:
        raise ValueError(pattern)
    keys = np.full(PADDED, PAD_KEY, dtype=np.uint32)
    keys[:n] = np.sort(live)
    return keys


def _values(dtype: str, rng) -> np.ndarray:
    """PADDED values of ``dtype``; sums wrap for the integers.

    int32: mostly below -2^30, some small and positive, so that signed and
    unsigned min and max differ and the means stay far from a cancellation.
    """
    if dtype == "int32":
        vals = rng.integers(-(2**31), -(2**30), PADDED)
        return np.where(rng.random(PADDED) < 0.1, rng.integers(0, 1000, PADDED), vals).astype(
            np.int32)
    if dtype == "uint32":
        return rng.integers(2**31 - 2**20, 2**32, PADDED, dtype=np.uint32)  # most above 2^31
    vals = rng.uniform(0.5, 1.5, PADDED).astype(np.float32)
    vals[rng.random(PADDED) < 0.002] = np.nan
    return vals


def _groups(keys: np.ndarray, n: int) -> int:
    """The runs that end on a live row: where the next key differs, or at the buffer's end."""
    ends = np.append(keys[1:] != keys[:-1], True)
    return int(ends[:n].sum())


def _both(vals: np.ndarray, kinds=KINDS):
    """The (name, values, kind) inputs of both packages."""
    jin = [(k, None if k == "count" else jnp.asarray(vals), k) for k in kinds]
    tv = torch.from_numpy(vals)
    return jin, [(k, None if k == "count" else tv, k) for k in kinds]


def _check(got, want, n_groups: int | None = None):
    """The port's (keys, {name: values}, count) against the JAX package's."""
    gkeys, gout, gcount = got
    wkeys, wout, wcount = want
    assert gcount.dtype == torch.int32 and gcount.dim() == 0
    assert int(gcount) == int(wcount)
    if n_groups is not None:
        assert int(gcount) == n_groups
    np.testing.assert_array_equal(gkeys.numpy(), np.asarray(wkeys))
    assert gkeys.dtype == torch.uint32
    assert list(gout) == list(wout)
    for name, w in wout.items():
        g, w = gout[name].numpy(), np.asarray(w)
        assert g.dtype == w.dtype, name
        if g.dtype == np.float32 and name in ("sum", "mean"):
            np.testing.assert_allclose(g, w, rtol=FLOAT_RTOL, err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)  # NaN equals NaN here


@pytest.mark.parametrize("pattern", ["random", "all_equal", "all_unique", "pad_run"])
@pytest.mark.parametrize("dtype", ["int32", "uint32", "float32"])
def test_segment_aggregate_matches_jax(dtype, pattern, rng):
    keys = _keys(pattern, rng)
    vals = _values(dtype, rng)
    jin, tin = _both(vals)
    want = jagg.aggregate_sorted_flat(jnp.asarray(keys), N_LIVE, jin, JCFG)
    tkeys = torch.from_numpy(keys)
    groups = _groups(keys, N_LIVE)
    assert groups == np.unique(keys[:N_LIVE]).size - (pattern == "pad_run")  # pad key's run dropped
    _check(tkagg.segment_aggregate(tkeys, N_LIVE, tin, impl="reference"), want, groups)
    _check(tagg.aggregate_sorted_flat(tkeys, N_LIVE, tin), want, groups)


@pytest.mark.parametrize("as_tensor", [False, True])
@pytest.mark.parametrize("n_live", ["zero", "one", "padded", "inside_a_group"])
def test_segment_aggregate_live_lengths(n_live, as_tensor, rng):
    keys = np.sort(rng.integers(0, 40, PADDED, dtype=np.uint32))  # every row live-able
    n = {"zero": 0, "one": 1, "padded": PADDED,
         "inside_a_group": int(np.searchsorted(keys, keys[PADDED // 2])) + 3}[n_live]
    assert n_live != "inside_a_group" or keys[n - 1] == keys[n]  # the group runs past n
    vals = _values("int32", rng)
    jin, tin = _both(vals)
    want = jagg.aggregate_sorted_flat(jnp.asarray(keys), n, jin, JCFG)
    live = torch.tensor(n, dtype=torch.int32) if as_tensor else n
    groups = _groups(keys, n)
    tkeys = torch.from_numpy(keys)
    _check(tkagg.segment_aggregate(tkeys, live, tin, impl="reference"), want, groups)
    _check(tagg.aggregate_sorted_flat(tkeys, live, tin), want, groups)


def test_segment_aggregate_nine_aggregates_of_three_columns(rng):
    # More than a launch's eight aggregates, over int32, uint32 and float32
    # columns: the kernel takes two launches; the plain version none.
    keys = _keys("random", rng)
    cols = {d: _values(d, rng) for d in ("int32", "uint32", "float32")}
    spec = [("i_sum", "int32", "sum"), ("u_min", "uint32", "min"), ("f_max", "float32", "max"),
            ("n", None, "count"), ("i_mean", "int32", "mean"), ("u_max", "uint32", "max"),
            ("f_sum", "float32", "sum"), ("u_mean", "uint32", "mean"), ("f_min", "float32", "min")]
    jin = [(name, None if d is None else jnp.asarray(cols[d]), k) for name, d, k in spec]
    tcols = {d: torch.from_numpy(v) for d, v in cols.items()}
    tin = [(name, None if d is None else tcols[d], k) for name, d, k in spec]
    want = jagg.aggregate_sorted_flat(jnp.asarray(keys), N_LIVE, jin, JCFG)
    got = tkagg.segment_aggregate(torch.from_numpy(keys), N_LIVE, tin, impl="reference")
    assert int(got[2]) == int(want[2])
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    for name, _, kind in spec:
        g, w = got[1][name].numpy(), np.asarray(want[1][name])
        assert g.dtype == w.dtype, name
        if g.dtype == np.float32 and kind in ("sum", "mean"):
            np.testing.assert_allclose(g, w, rtol=FLOAT_RTOL, err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)
    plans = tkagg.launch_plan(tin)
    assert [len(p["outputs"]) for p in plans] == [8, 1]


def test_launch_plan_shares_columns_and_accumulators():
    i32 = torch.zeros(8, dtype=torch.int32)
    f32 = torch.zeros(8, dtype=torch.float32)
    inputs = [("s", i32, "sum"), ("c", None, "count"), ("lo", i32, "min"), ("m", i32, "mean"),
              ("fs", f32, "sum"), ("fm", f32, "mean"), ("hi", i32, "max")]
    (plan,) = tkagg.launch_plan(inputs)
    assert len(plan["columns"]) == 2  # each distinct column read once
    assert plan["columns"][0] is i32 and plan["columns"][1] is f32
    assert plan["accs"] == [(tkagg.SUM_U32, 0), (tkagg.COUNT, -1), (tkagg.MIN_I32, 0),
                            (tkagg.SUM_I32_AS_F32, 0), (tkagg.SUM_F32, 1), (tkagg.MAX_I32, 0)]
    outs = {name: (dtype, acc, cnt) for name, dtype, acc, cnt in plan["outputs"]}
    assert outs["c"] == (torch.int32, 1, -1)
    assert outs["m"] == (torch.float32, 3, 1)  # the count shared with "c"
    assert outs["fs"] == (torch.float32, 4, -1) and outs["fm"] == (torch.float32, 4, 1)
    assert outs["hi"] == (torch.int32, 5, -1)
    # No aggregate at all: one launch, for the group keys and the count.
    assert tkagg.launch_plan([]) == [{"columns": [], "accs": [], "outputs": []}]


def test_segment_aggregate_without_aggregates(rng):
    keys = _keys("random", rng)
    want = jagg.aggregate_sorted_flat(jnp.asarray(keys), N_LIVE, [], JCFG)
    _check(tkagg.segment_aggregate(torch.from_numpy(keys), N_LIVE, []), want)


def test_segment_aggregate_rejects_bad_inputs():
    keys = torch.zeros(16, dtype=torch.int32).view(torch.uint32)
    v = torch.zeros(16, dtype=torch.int32)
    with pytest.raises(ValueError, match="unsupported aggregation"):
        tkagg.segment_aggregate(keys, 16, [("x", v, "median")])
    with pytest.raises(ValueError, match="needs a column"):
        tkagg.segment_aggregate(keys, 16, [("x", None, "sum")])
    with pytest.raises(TypeError, match="int32, uint32 or float32"):
        tkagg.segment_aggregate(keys, 16, [("x", v.to(torch.int64), "sum")])
    with pytest.raises(ValueError, match="keys' 16 rows"):
        tkagg.segment_aggregate(keys, 16, [("x", v[:8], "sum")])
    with pytest.raises(ValueError, match="uint32"):
        tkagg.segment_aggregate(v, 16, [("x", v, "sum")])
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        tkagg.segment_aggregate(keys, 16, [("x", v, "sum")], impl="cuda")
    launched = tkagg.segment_aggregate.launches
    tkagg.segment_aggregate(keys, 16, [("x", v, "sum")])  # the CPU: the plain version
    assert tkagg.segment_aggregate.launches == launched


@pytest.mark.parametrize("pattern", ["random", "all_equal", "all_unique", "pad_run"])
@pytest.mark.parametrize("dtype", ["int32", "uint32", "float32"])
def test_segment_aggregate_with_rows_matches_jax(dtype, pattern, rng):
    # The table's keys unsorted; the JAX package sorts the table and
    # aggregates the gathered column, the port reads the unsorted column
    # through the JAX package's permutation (PAD_INDEX, -1 as int32, on the
    # pad rows).
    keys = rng.permutation(_keys(pattern, rng)[:N_LIVE])
    vals = _values(dtype, rng)[:N_LIVE]
    jt = jtable.table_from_arrays(JCFG, v=vals).with_column("k", jtable.make_key_column(keys, JCFG))
    ordered = jsort.sort_table(jt, "k", JCFG)
    jin = [(k, None if k == "count" else ordered["v"].data, k) for k in KINDS]
    want = jagg.aggregate_sorted_flat(ordered["k"].data, N_LIVE, jin, JCFG)
    sorted_keys, perm = jsort.sort_pairs(jt["k"], JCFG)
    np.testing.assert_array_equal(np.asarray(sorted_keys.data), np.asarray(ordered["k"].data))
    rows = torch.from_numpy(np.asarray(perm.data).view(np.int32).copy())
    assert (rows[N_LIVE:] == -1).all() and rows.numel() == PADDED
    tkeys = torch.from_numpy(np.asarray(sorted_keys.data).copy())
    tv = torch.from_numpy(np.asarray(jt["v"].data).copy())  # unsorted, the table's padded column
    tin = [(k, None if k == "count" else tv, k) for k in KINDS]
    groups = _groups(np.asarray(sorted_keys.data), N_LIVE)
    _check(tkagg.segment_aggregate(tkeys, N_LIVE, tin, rows=rows, impl="reference"), want, groups)
    _check(tagg.aggregate_sorted_flat(tkeys, N_LIVE, tin, rows), want, groups)


@pytest.mark.parametrize("n_live", ["padded", "pads_at_minus_one", "inside_a_group"])
def test_segment_aggregate_with_rows_past_n_live(n_live, rng):
    # Rows that are not a sort's: random rows of a column twice the keys'
    # length, -1 past the live length (pad rows); the JAX package's gather
    # clamps as the port's does.
    keys = np.sort(rng.integers(0, 40, PADDED, dtype=np.uint32))
    n = {"padded": PADDED, "pads_at_minus_one": N_LIVE,
         "inside_a_group": int(np.searchsorted(keys, keys[PADDED // 2])) + 3}[n_live]
    assert n_live != "inside_a_group" or keys[n - 1] == keys[n]  # the group runs past n
    col = _values("int32", rng)
    col = np.concatenate([col, _values("int32", rng)])
    rows = rng.integers(0, col.size, PADDED).astype(np.int32)
    rows[n:] = -1
    gathered = jpermute.gather_rows(jnp.asarray(col), jnp.clip(jnp.asarray(rows), 0, col.size - 1))
    jin = [(k, None if k == "count" else gathered, k) for k in KINDS]
    want = jagg.aggregate_sorted_flat(jnp.asarray(keys), n, jin, JCFG)
    tin = [(k, None if k == "count" else torch.from_numpy(col), k) for k in KINDS]
    tkeys, trows = torch.from_numpy(keys), torch.from_numpy(rows)
    groups = _groups(keys, n)
    for live in (n, torch.tensor(n, dtype=torch.int32)):
        _check(tkagg.segment_aggregate(tkeys, live, tin, rows=trows, impl="reference"), want,
               groups)
        _check(tagg.aggregate_sorted_flat(tkeys, live, tin, trows), want, groups)


def test_segment_aggregate_refuses_bad_rows():
    keys = torch.zeros(16, dtype=torch.int32).view(torch.uint32)
    v = torch.zeros(16, dtype=torch.int32)
    rows = torch.arange(16, dtype=torch.int32)
    bad = {"int64": rows.to(torch.int64), "uint32": rows.view(torch.uint32),
           "short": rows[:8], "long": torch.arange(17, dtype=torch.int32),
           "2-D": rows.view(4, 4), "strided": torch.arange(32, dtype=torch.int32)[::2],
           "another device": rows.to("meta")}
    for what, r in bad.items():
        with pytest.raises(ValueError, match="rows must be a contiguous torch.int32"):
            tkagg.segment_aggregate(keys, 16, [("x", v, "sum")], rows=r)
    with pytest.raises(ValueError, match="at least one row"):
        tkagg.segment_aggregate(keys, 16, [("x", v[:0], "sum")], rows=rows)
    with pytest.raises(ValueError, match="read through rows"):
        tkagg.segment_aggregate(keys, 16, [("x", v.view(4, 4), "sum")], rows=rows)
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        tkagg.segment_aggregate(keys, 16, [("x", v, "sum")], rows=rows, impl="cuda")
    # A column of another length than the keys is read through rows.
    got = tkagg.segment_aggregate(keys, 16, [("x", torch.arange(3, dtype=torch.int32), "sum")],
                                  rows=rows % 3)
    assert int(got[2]) == 1 and int(got[1]["x"][0]) == sum(i % 3 for i in range(16))
