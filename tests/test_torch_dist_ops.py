"""The port's distributed group-by and join against the JAX package's, shard for shard.

The JAX package runs on its virtual CPU devices, the port on 2 or 4 gloo
ranks spawned by ``run_ranks`` (one world per size), from the same numpy
inputs.  Every shard's live prefix (keys and values), the counts and the
overflow flag must be equal; float means within ``FLOAT_RTOL`` (the same
tolerance as ``tests/test_torch_ops.py``: the port sums in float64 and
rounds once, the JAX package adds float32 in a tree).  The gathered results
are also held against numpy.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from gpuradixsort_tpu.config import PAD_KEY
from gpuradixsort_tpu.config import EngineConfig as JaxConfig
from gpuradixsort_tpu.core.table import round_up
from gpuradixsort_tpu.parallel import dist_ops as jops
from gpuradixsort_tpu.parallel.mesh import make_row_mesh
from gpuradixsort_tpu_torch.config import EngineConfig
from gpuradixsort_tpu_torch.parallel.launch import run_ops, run_ranks
from gpuradixsort_tpu_torch.utils.verify import join_oracle

CFG = EngineConfig()
JCFG = JaxConfig()
SEED = 20170101
TIMEOUT = 240.0
FLOAT_RTOL = 1e-5
AGGS = {"s": ("v", "sum"), "c": ("v", "count"), "mx": ("v", "max"), "mn": ("v", "min"),
        "m": ("v", "mean"), "fs": ("f", "sum")}


def _pad(arr, num_shards, fill):
    out = np.full(round_up(arr.size, num_shards * CFG.block), fill, arr.dtype)
    out[: arr.size] = arr
    return out


def _agg_case(gen, n, skewed=False):
    if skewed:  # one dominant key: the default slack overflows, auto-retry recovers
        keys = np.where(gen.random(n) < 0.9, np.uint32(42),
                        gen.integers(0, 2**32, n).astype(np.uint32))
        return keys, {"v": np.ones(n, np.int32)}, {"c": ("v", "sum")}
    keys = gen.integers(0, 500, n, dtype=np.uint32)
    vals = {"v": gen.integers(-1000, 1000, n).astype(np.int32),
            # quarters: float32 sums of them are exact, so only the mean rounds
            "f": (gen.integers(-400, 400, n) / 4).astype(np.float32)}
    return keys, vals, AGGS


def _join_case(gen, n_p, n_b, kmax, miss=False):
    pk = gen.integers(0, kmax, n_p, dtype=np.uint32)
    bk = gen.integers(1000 if miss else 0, 1000 + kmax if miss else kmax, n_b, dtype=np.uint32)
    pv = gen.integers(0, 2**31, n_p).astype(np.uint32)
    bv = gen.integers(0, 2**31, n_b).astype(np.uint32)
    return pk, pv, bk, bv


# name -> (world size, op, inputs from the generator, keyword args)
CASES = {
    "aggregate_p4": (4, "aggregate", lambda g: _agg_case(g, 40_000), {}),
    "aggregate_skewed_retry": (4, "aggregate", lambda g: _agg_case(g, 40_000, True), {}),
    "join_duplicates_p4": (4, "join", lambda g: _join_case(g, 20_000, 10_000, 300),
                           {"join_cap_factor": 8.0}),
    "join_no_matches": (4, "join", lambda g: _join_case(g, 8_192, 8_192, 100, miss=True), {}),
    "aggregate_p2": (2, "aggregate", lambda g: _agg_case(g, 40_000), {}),
    "join_duplicates_p2": (2, "join", lambda g: _join_case(g, 20_000, 10_000, 300),
                           {"join_cap_factor": 8.0}),
}


@pytest.fixture(scope="module")
def inputs():
    gen = np.random.default_rng(SEED)
    return {name: make(gen) for name, (_, _, make, _) in CASES.items()}


def _call(name, data, size):
    _, op, _, kw = CASES[name]
    if op == "aggregate":
        keys, vals, aggs = data
        inputs = {"keys": _pad(keys, size, np.uint32(PAD_KEY)),
                  "values": {k: _pad(v, size, v.dtype.type(0)) for k, v in vals.items()}}
        kwargs = {"aggs": aggs, "n_live": keys.size}
    else:
        pk, pv, bk, bv = data
        inputs = {"probe_keys": _pad(pk, size, np.uint32(PAD_KEY)), "probe_values": _pad(pv, size, 0),
                  "build_keys": _pad(bk, size, np.uint32(PAD_KEY)), "build_values": _pad(bv, size, 0)}
        kwargs = {"n_probe": pk.size, "n_build": bk.size}
    return {"op": op, "inputs": inputs, "kwargs": {"cfg": CFG, **kwargs, **kw}, "gather": True}


@pytest.fixture(scope="module")
def port(inputs):
    out = {}
    for size in (2, 4):
        names = [name for name, (p, *_) in CASES.items() if p == size]
        calls = [_call(name, inputs[name], size) for name in names]
        ranks = run_ranks(size, run_ops, (calls,), device="cpu", timeout=TIMEOUT)
        out.update({name: sorted((r[i] for r in ranks), key=lambda x: x["shard"])
                    for i, name in enumerate(names)})
    return out


def _jax(name, data):
    size, op, _, kw = CASES[name]
    mesh = make_row_mesh(size)
    call = _call(name, data, size)
    a = {k: jnp.asarray(v) for k, v in call["inputs"].items() if k != "values"}
    if op == "aggregate":
        vals = {k: jnp.asarray(v) for k, v in call["inputs"]["values"].items()}
        res = jops.dist_group_by_aggregate(a["keys"], vals, data[2], mesh, JCFG, method="radix",
                                           n_live=data[0].size)
        return res, {"keys": res.keys, **res.values}
    res = jops.dist_join_inner(a["probe_keys"], a["probe_values"], a["build_keys"],
                               a["build_values"], mesh, JCFG, method="radix",
                               n_probe=data[0].size, n_build=data[2].size, **kw)
    return res, {"keys": res.keys, "probe_values": res.probe_values,
                 "build_values": res.build_values}


def _numpy_groups(keys, vals, aggs):
    uniq, inv = np.unique(keys, return_inverse=True)
    out = {}
    for name, (v, kind) in aggs.items():
        x = vals[v]
        if kind == "count":
            out[name] = np.bincount(inv, minlength=uniq.size)
        elif kind in ("sum", "mean"):
            s = np.bincount(inv, weights=x.astype(np.float64), minlength=uniq.size)
            out[name] = s if kind == "sum" else s / np.bincount(inv)
        else:
            red = np.full(uniq.size, np.inf if kind == "min" else -np.inf)
            (np.minimum if kind == "min" else np.maximum).at(red, inv, x)
            out[name] = red
    return uniq, out


@pytest.mark.parametrize("name", list(CASES))
def test_dist_op_matches_jax(name, inputs, port):
    data = inputs[name]
    want, cols = _jax(name, data)
    counts = np.asarray(want.counts)
    floats = {"m", "fs"}
    for s, got in enumerate(port[name]):
        assert got["shard"] == s
        assert not bool(want.overflow) and not got["overflow"]
        np.testing.assert_array_equal(got["counts"], counts)
        for col, arr in cols.items():
            w = np.asarray(arr)[s, : counts[s]]
            if col in floats:
                np.testing.assert_allclose(got["live"][col], w, rtol=FLOAT_RTOL, err_msg=col)
            else:
                assert got["live"][col].dtype == w.dtype, col
                np.testing.assert_array_equal(got["live"][col], w, err_msg=col)

    gathered = port[name][0]["gathered"]
    if CASES[name][1] == "aggregate":
        keys, vals, aggs = data
        uniq, want_vals = _numpy_groups(keys, vals, aggs)
        np.testing.assert_array_equal(gathered[0], uniq)
        for out_name, w in want_vals.items():
            tol = FLOAT_RTOL if out_name in floats else 0
            np.testing.assert_allclose(gathered[1][out_name], w, rtol=tol, atol=tol,
                                       err_msg=out_name)
    else:
        for g, w in zip(gathered, join_oracle(*data)):
            np.testing.assert_array_equal(g, w)
        if name == "join_no_matches":
            assert gathered[0].size == 0 and counts.sum() == 0
