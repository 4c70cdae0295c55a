"""The port's distributed sort against the JAX package's, shard for shard.

The JAX package runs on its 8 virtual CPU devices (``tests/conftest.py``),
the port on 2, 3 or 4 gloo ranks spawned by ``run_ranks``; both take the
same numpy inputs, made from one seed.  Every shard's live prefix of keys
and index, the counts and the overflow flag must be equal element for
element, and the gathered result must equal numpy's stable sort.

The cases of one world size run in one spawned world (a module fixture),
so the file spawns three worlds.  The ring schedule is held against the
JAX package's ``_dist_sort_padded(..., overlap=True)`` called directly:
its ``dist_sort_pairs`` drops ``overlap``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpuradixsort_tpu.config import PAD_KEY
from gpuradixsort_tpu.config import EngineConfig as JaxConfig
from gpuradixsort_tpu.core.table import round_up
from gpuradixsort_tpu.parallel import dist_sort as jdist
from gpuradixsort_tpu.parallel.mesh import make_row_mesh
from gpuradixsort_tpu_torch.config import EngineConfig
from gpuradixsort_tpu_torch.parallel import dist_sort as tdist
from gpuradixsort_tpu_torch.parallel.launch import run_ops, run_ranks

CFG = EngineConfig()
JCFG = JaxConfig()
SEED = 20170101
TIMEOUT = 240.0


def _max_keys(gen, n):
    return np.where(gen.integers(0, 2, size=n).astype(bool), np.uint32(0xFFFFFFFF),
                    gen.integers(0, 1000, size=n, dtype=np.uint32))


def _skewed(gen):
    keys = np.concatenate([gen.integers(0, 1000, size=45_000, dtype=np.uint32),
                           gen.integers(0, 2**32, size=5_000, dtype=np.uint32)])
    gen.shuffle(keys)
    return keys


# name -> (world size, keys from the generator, keyword args), in the order
# the generator makes them.  "ring" cases take overlap=True.
CASES = {
    "random_p2": (2, lambda g: g.integers(0, 2**32, size=50_000, dtype=np.uint32), {}),
    "random": (4, lambda g: g.integers(0, 2**32, size=50_000, dtype=np.uint32), {}),
    "duplicates": (4, lambda g: g.integers(0, 16, size=30_000, dtype=np.uint32), {}),
    "max_keys": (4, lambda g: _max_keys(g, 20_000), {}),
    "skewed_cap3": (4, _skewed, {"cap_factor": 3.0}),
    "overflow_no_retry": (4, lambda g: np.full(40_000, 12345, dtype=np.uint32),
                          {"cap_factor": 1.5, "auto_retry": False}),
    "overflow_more_slack": (4, lambda g: np.full(40_000, 12345, dtype=np.uint32),
                            {"cap_factor": 4.8}),
    "all_equal_untuned": (4, lambda g: np.full(40_000, 7, dtype=np.uint32), {}),
    "narrow_range": (4, lambda g: g.integers(0, 5, size=40_000, dtype=np.uint32), {}),
    "torch_method": (4, lambda g: g.integers(0, 2**20, size=40_000, dtype=np.uint32),
                     {"method": "torch"}),
    "ring_p4": (4, lambda g: g.integers(0, 2**32, size=48_000, dtype=np.uint32),
                {"overlap": True}),
    "ring_stability": (4, lambda g: g.integers(0, 8, size=30_000, dtype=np.uint32),
                       {"overlap": True}),
    "ring_max_keys": (4, lambda g: _max_keys(g, 20_000), {"overlap": True}),
    "ring_p3": (3, lambda g: g.integers(0, 2**32, size=48_000, dtype=np.uint32),
                {"overlap": True}),
    "resort_p3": (3, lambda g: g.integers(0, 2**32, size=48_000, dtype=np.uint32), {}),
}


def _padded(keys: np.ndarray, num_shards: int) -> np.ndarray:
    out = np.full(round_up(keys.size, num_shards * CFG.block), np.uint32(PAD_KEY), np.uint32)
    out[: keys.size] = keys
    return out


@pytest.fixture(scope="module")
def inputs():
    gen = np.random.default_rng(SEED)
    return {name: make(gen) for name, (_, make, _) in CASES.items()}


def _world(size, inputs):
    names = [name for name, (p, _, _) in CASES.items() if p == size]
    calls = [{"op": "sort", "inputs": {"keys": _padded(inputs[name], size)},
              "kwargs": {"cfg": CFG, "n_live": inputs[name].size, **CASES[name][2]},
              "gather": True} for name in names]
    ranks = run_ranks(size, run_ops, (calls,), device="cpu", timeout=TIMEOUT)
    # by case: each shard's result, in shard order
    return {name: sorted((r[i] for r in ranks), key=lambda x: x["shard"])
            for i, name in enumerate(names)}


@pytest.fixture(scope="module")
def port(inputs):
    out = {}
    for size in (2, 3, 4):
        out.update(_world(size, inputs))
    return out


def _jax(name, keys):
    size, _, kw = CASES[name]
    mesh = make_row_mesh(size)
    padded = jnp.asarray(_padded(keys, size))
    if kw.get("overlap"):
        mk, mi, counts, overflow = jdist._dist_sort_padded(
            padded, jnp.uint32(keys.size), mesh=mesh, cfg=JCFG, bucket_bits=12,
            cap_factor=2.0, method="radix", overlap=True)
        return jdist.ShardedSort(mk, mi, counts, overflow)
    kw = {k: v for k, v in kw.items() if k != "method"}  # "torch" against JAX's radix
    return jdist.dist_sort_pairs(padded, mesh, JCFG, n_live=keys.size, method="radix", **kw)


@pytest.mark.parametrize("name", list(CASES))
def test_dist_sort_matches_jax(name, inputs, port):
    keys = inputs[name]
    want = _jax(name, keys)
    shards = port[name]
    counts = np.asarray(want.counts)
    assert bool(want.overflow) == shards[0]["overflow"]
    for s, got in enumerate(shards):
        assert got["shard"] == s and got["overflow"] == bool(want.overflow)
        np.testing.assert_array_equal(got["counts"], counts)
        np.testing.assert_array_equal(got["live"]["keys"], np.asarray(want.keys)[s, : counts[s]])
        np.testing.assert_array_equal(got["live"]["index"],
                                      np.asarray(want.index)[s, : counts[s]])
    if bool(want.overflow):
        assert "overflow" in shards[0]["gather_error"]
        return
    out_k, out_i = shards[0]["gathered"]
    np.testing.assert_array_equal(out_k, np.sort(keys))
    np.testing.assert_array_equal(out_i, np.argsort(keys, kind="stable").astype(np.uint32))


def test_every_shard_holds_live_rows(inputs, port):
    # The balanced partition spreads random keys: no shard is empty, none full.
    for name in ("random", "random_p2", "ring_p3"):
        counts = port[name][0]["counts"]
        assert counts.sum() == inputs[name].size and counts.min() > 0


def _jax_shard_of_bucket(hist: np.ndarray, num_shards: int) -> np.ndarray:
    """The JAX package's expression (dist_sort.py:261-266), int32 as it runs there."""
    h = jnp.asarray(hist, jnp.int32)
    total = jnp.maximum(jnp.sum(h), 1)
    mid = jnp.cumsum(h) - h + h // 2
    return np.asarray(jnp.clip((mid * num_shards) // total, 0, num_shards - 1))


@pytest.mark.parametrize("num_shards", [1, 2, 3, 4, 8])
def test_shard_of_bucket_matches_jax_on_small_totals(num_shards):
    gen = np.random.default_rng(SEED)
    for hist in (gen.integers(0, 1000, 4096), np.zeros(16, np.int64), np.eye(1, 64, 5)[0] * 99,
                 gen.integers(0, 3, 17) * gen.integers(0, 10**5, 17)):
        got = tdist._shard_of_bucket(torch.from_numpy(hist.astype(np.int64)), num_shards)
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), _jax_shard_of_bucket(hist, num_shards))


def test_shard_of_bucket_int64_where_jax_wraps():
    # 1.2e9 rows on 4 shards: mid * 4 passes 2^31.  A synthetic histogram
    # stands for the data; no large array is made.
    hist = np.full(4, 300_000_000, dtype=np.int64)
    np.testing.assert_array_equal(tdist._shard_of_bucket(torch.from_numpy(hist), 4).numpy(),
                                  [0, 1, 2, 3])
    np.testing.assert_array_equal(_jax_shard_of_bucket(hist, 4), [0, 1, 0, 0])  # the defect
    gen = np.random.default_rng(SEED)
    hist = gen.multinomial(1_200_000_000, np.full(4096, 1 / 4096)).astype(np.int64)
    mid = np.cumsum(hist) - hist + hist // 2  # numpy int64 oracle
    want = np.clip(mid * 4 // hist.sum(), 0, 3)
    got = tdist._shard_of_bucket(torch.from_numpy(hist), 4).numpy()
    np.testing.assert_array_equal(got, want)
    assert np.all(np.diff(got) >= 0) and set(got) == {0, 1, 2, 3}
    assert np.any(np.diff(_jax_shard_of_bucket(hist, 4)) < 0)  # JAX's map is not monotone here


def _runs(gen, p, length, hi):
    keys = np.sort(gen.integers(0, hi, size=(p, length), dtype=np.uint32), axis=1)
    keys[:, -3:] = 0xFFFFFFFF  # pad-like tails tie with each other
    payload = gen.integers(0, 2**32, size=(p, length), dtype=np.uint32)
    return keys, payload


@pytest.mark.parametrize("hi", [8, 2**32])
def test_merge_pair_matches_jax(hi):
    gen = np.random.default_rng(SEED)
    keys, payload = _runs(gen, 2, 1000, hi)
    want_k, (want_p,) = jdist._merge_pair(jnp.asarray(keys[0]), jnp.asarray(keys[1]),
                                          (jnp.asarray(payload[0]),), (jnp.asarray(payload[1]),))
    t = torch.from_numpy
    got_k, (got_p,) = tdist._merge_pair(t(keys[0]), t(keys[1]), (t(payload[0]),),
                                        (t(payload[1]),))
    np.testing.assert_array_equal(got_k.numpy(), np.asarray(want_k))
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))


@pytest.mark.parametrize("p", [1, 2, 4, 8])
def test_merge_runs_matches_jax(p):
    gen = np.random.default_rng(SEED)
    keys, payload = _runs(gen, p, 512, 50)
    want_k, (want_p,) = jdist._merge_runs(jnp.asarray(keys), (jnp.asarray(payload),))
    got_k, (got_p,) = tdist._merge_runs(torch.from_numpy(keys), (torch.from_numpy(payload),))
    np.testing.assert_array_equal(got_k.numpy(), np.asarray(want_k))
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))


def test_merge_runs_takes_power_of_two_runs():
    keys = torch.zeros((3, 8), dtype=torch.int32).view(torch.uint32)
    with pytest.raises(ValueError, match="power-of-two"):
        tdist._merge_runs(keys, ())


def test_composite_order_matches_key_then_index():
    # The ring's merge key: sorting it is sorting on (key, gidx) as uint32s,
    # with the pad sentinel pair last.
    gen = np.random.default_rng(SEED)
    keys = gen.choice(np.array([0, 1, 2**31 - 1, 2**31, 2**32 - 2, 2**32 - 1], np.uint32), 4000)
    gidx = gen.integers(0, 2**32 - 1, 4000, dtype=np.uint32)
    keys[-1], gidx[-1] = 0xFFFFFFFF, 0xFFFFFFFF
    comp = tdist._composite(torch.from_numpy(keys), torch.from_numpy(gidx))
    order = torch.argsort(comp, stable=True).numpy()
    np.testing.assert_array_equal(order, np.lexsort((gidx, keys)))
    assert order[-1] == keys.size - 1
