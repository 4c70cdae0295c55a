"""The port's multi-host pieces, entry points and import hygiene.

A real multi-node world cannot run here; what can is the single-process
no-op of ``initialize``, the node grouping of ``make_pod_mesh`` with four
gloo ranks told (as torchrun would tell them) that they sit on two nodes,
interleaved, and a sort over the flattened pod mesh.  The entry points run
as a caller would run them.
"""

import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpuradixsort_tpu.config import EngineConfig as JaxConfig
from gpuradixsort_tpu.parallel.dist_sort import dist_sort_pairs as jax_dist_sort_pairs
from gpuradixsort_tpu.parallel.mesh import make_row_mesh
from gpuradixsort_tpu.utils import native as jax_native
from gpuradixsort_tpu_torch import entry
from gpuradixsort_tpu_torch.config import EngineConfig
from gpuradixsort_tpu_torch.parallel import multihost
from gpuradixsort_tpu_torch.parallel.launch import run_ops, run_ranks
from gpuradixsort_tpu_torch.utils import native

CFG = EngineConfig()
SEED = 20170101

PORT_MODULES = [
    "gpuradixsort_tpu_torch.config",
    "gpuradixsort_tpu_torch.core.table",
    "gpuradixsort_tpu_torch.kernels._build",
    "gpuradixsort_tpu_torch.kernels.radix",
    "gpuradixsort_tpu_torch.kernels.scan",
    "gpuradixsort_tpu_torch.kernels.bucketize",
    "gpuradixsort_tpu_torch.kernels.scatter",
    "gpuradixsort_tpu_torch.ops.sort",
    "gpuradixsort_tpu_torch.ops.permute",
    "gpuradixsort_tpu_torch.ops.filter",
    "gpuradixsort_tpu_torch.ops.aggregate",
    "gpuradixsort_tpu_torch.ops.join",
    "gpuradixsort_tpu_torch.parallel.mesh",
    "gpuradixsort_tpu_torch.parallel.dist_sort",
    "gpuradixsort_tpu_torch.parallel.dist_ops",
    "gpuradixsort_tpu_torch.parallel.multihost",
    "gpuradixsort_tpu_torch.parallel.launch",
    "gpuradixsort_tpu_torch.utils.native",
    "gpuradixsort_tpu_torch.utils.timing",
    "gpuradixsort_tpu_torch.utils.verify",
    "gpuradixsort_tpu_torch.entry",
]


def test_port_imports_no_jax():
    # Of the JAX package, only the numpy/ctypes native bridge may load.
    code = ("import importlib, sys\n"
            f"for m in {PORT_MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "assert 'jax' not in sys.modules\n"
            "ref = {m for m in sys.modules if m.split('.')[0] == 'gpuradixsort_tpu'}\n"
            "assert ref <= {'gpuradixsort_tpu', 'gpuradixsort_tpu.utils',\n"
            "               'gpuradixsort_tpu.utils.native'}, ref\n")
    done = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120)
    assert done.returncode == 0, done.stderr


def test_initialize_single_process_is_noop(monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    assert multihost.initialize() is False
    assert not torch.distributed.is_initialized()


@pytest.fixture(scope="module")
def pod_world():
    """Four ranks on two interleaved nodes (ranks 0, 2 and 1, 3); sorts over the pod mesh."""
    gen = np.random.default_rng(SEED)
    n = 4 * CFG.block * 2
    keys = gen.integers(0, 2**32, size=n, dtype=np.uint32)
    calls = [{"op": "sort", "inputs": {"keys": keys}, "kwargs": {"cfg": CFG, **kw},
              "gather": True} for kw in ({}, {"overlap": True})]
    ranks = run_ranks(4, run_ops, (calls, True), nodes=[0, 1, 0, 1], timeout=240.0)
    return keys, ranks


def test_pod_mesh_groups_ranks_by_node(pod_world):
    _, ranks = pod_world
    for rank, (result, _) in enumerate(ranks):
        # Host-major: node 0's ranks 0, 2 are shards 0, 1; node 1's ranks 1, 3 are 2, 3.
        assert result["ranks"] == (0, 2, 1, 3)
        assert result["shard"] == (0, 2, 1, 3).index(rank)


@pytest.mark.parametrize("schedule", [0, 1], ids=["all_to_all", "ring"])
def test_sort_over_flattened_pod_mesh(schedule, pod_world):
    keys, ranks = pod_world
    by_shard = sorted((r[schedule] for r in ranks), key=lambda x: x["shard"])
    out_k, out_i = by_shard[0]["gathered"]
    np.testing.assert_array_equal(out_k, np.sort(keys))
    np.testing.assert_array_equal(out_i, np.argsort(keys, kind="stable").astype(np.uint32))
    # Shard s holds global slice s whatever its rank, so it equals the JAX shard s.
    want = jax_dist_sort_pairs(jnp.asarray(keys), make_row_mesh(4), JaxConfig(), method="radix")
    counts = np.asarray(want.counts)
    for s, got in enumerate(by_shard):
        np.testing.assert_array_equal(got["counts"], counts)
        np.testing.assert_array_equal(got["live"]["keys"], np.asarray(want.keys)[s, : counts[s]])
        np.testing.assert_array_equal(got["live"]["index"],
                                      np.asarray(want.index)[s, : counts[s]])


def test_entry_sorts_like_numpy():
    fn, (keys, idx) = entry.entry(device="cpu")
    assert keys.numel() == 64 * CFG.block
    sorted_keys, perm = fn(keys, idx)
    k = keys.numpy()
    np.testing.assert_array_equal(sorted_keys.numpy(), np.sort(k))
    np.testing.assert_array_equal(perm.numpy(), np.argsort(k, kind="stable").astype(np.uint32))


def test_entry_dryrun_multichip():
    out = entry.dryrun_multichip(4)
    assert out["join"]["gathered"][0].size > 0
    assert all(out[op]["transport"] == "gloo" for op in ("sort", "aggregate", "join"))


def test_native_is_the_jax_packages():
    assert native.radix_sort_pairs is jax_native.radix_sort_pairs
    keys = native.random_keys(5000, seed=3)
    sk, si = native.radix_sort_pairs(keys)
    np.testing.assert_array_equal(sk, np.sort(keys))
    np.testing.assert_array_equal(si, np.argsort(keys, kind="stable").astype(np.uint32))


def test_run_ranks_raises_when_a_rank_fails():
    # Every rank raises inside the op; the parent gets each traceback, no hang.
    calls = [{"op": "no such op", "inputs": {"keys": np.zeros(2 * CFG.block, np.uint32)}}]
    with pytest.raises(RuntimeError, match="2 of 2 ranks failed(.|\n)*unknown op"):
        run_ranks(2, run_ops, (calls,), timeout=120.0)
