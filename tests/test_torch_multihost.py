"""The port's multi-host pieces, entry points, native bridge and import hygiene.

A real multi-node world cannot run here; what can is the single-process
no-op of ``initialize``, the node grouping of ``make_pod_mesh`` with four
gloo ranks told (as torchrun would tell them) that they sit on two nodes,
interleaved, and a sort over the flattened pod mesh.  The entry points run
as a caller would run them, with ``device="cpu"``; without it they need a
card, and raise where there is none.
"""

import pathlib
import shutil
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
from gpuradixsort_tpu_torch.parallel import mesh as mesh_mod
from gpuradixsort_tpu_torch.parallel import multihost
from gpuradixsort_tpu_torch.parallel.launch import run_ops, run_ranks
from gpuradixsort_tpu_torch.utils import native

CFG = EngineConfig()
SEED = 20170101

REPO = pathlib.Path(__file__).resolve().parents[1]


def test_port_imports_no_jax():
    # Every module of the port, and chip_smoke.py: no JAX, nothing of the JAX package.
    code = ("import importlib, pkgutil, sys\n"
            "import gpuradixsort_tpu_torch as pkg\n"
            "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
            "assert len(names) > 20, names\n"
            "for m in names + ['chip_smoke']:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'gpuradixsort_tpu'))\n"
            "assert not bad, bad\n")
    done = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, cwd=REPO)
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
    ranks = run_ranks(4, run_ops, (calls, True), device="cpu", nodes=[0, 1, 0, 1],
                      timeout=240.0)
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
    out = entry.dryrun_multichip(4, device="cpu")
    assert out["join"]["gathered"][0].size > 0
    assert all(out[op]["transport"] == "gloo" for op in ("sort", "aggregate", "join"))


@pytest.fixture
def no_card(monkeypatch):
    """This process as it would be on a machine without a CUDA card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_need_a_card_unless_cpu(no_card):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry.entry()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry.dryrun_multichip(4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_ranks(2, run_ops, ([],))
    fn, (keys, _) = entry.entry(device="cpu")
    assert keys.device.type == "cpu"


def test_meshes_need_a_card_unless_cpu(no_card, tmp_path):
    dist = torch.distributed
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}",
                            world_size=1, rank=0)
    try:
        for make in (mesh_mod.make_row_mesh, lambda **kw: mesh_mod.row_mesh_in_order([0], **kw),
                     multihost.make_pod_mesh):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                make()
            assert make(device="cpu").device == torch.device("cpu")
    finally:
        dist.destroy_process_group()


def test_native_is_the_ports_own():
    # Built from native/qehost.cpp into build/native/, never under native/.
    if shutil.which("g++") is None:
        pytest.skip("no g++: the bridge runs its numpy fall-backs")
    assert native.available()
    path = native.library_path()
    assert path.exists() and path.parent == REPO / "build" / "native"


@pytest.mark.parametrize("fn", ["random_keys", "shuffled_permutation", "radix_sort_pairs",
                                "first_unsorted"])
def test_native_matches_the_jax_packages(fn):
    for seed in (0, 3, 20170101):
        n = 5000 + seed % 7
        keys = jax_native.random_keys(n, seed=seed)
        if fn in ("random_keys", "shuffled_permutation"):
            got, want = getattr(native, fn)(n, seed=seed), getattr(jax_native, fn)(n, seed=seed)
            assert got.dtype == want.dtype == np.uint32
            np.testing.assert_array_equal(got, want)
        elif fn == "radix_sort_pairs":
            idx = jax_native.shuffled_permutation(n, seed=seed + 1)
            for args in ((keys,), (keys, idx)):
                for g, w in zip(native.radix_sort_pairs(*args), jax_native.radix_sort_pairs(*args)):
                    np.testing.assert_array_equal(g, w)
        else:
            for arr in (keys, np.sort(keys), np.arange(n, dtype=np.uint32)[::-1].copy()):
                assert native.first_unsorted(arr) == jax_native.first_unsorted(arr)


def test_run_ranks_raises_when_a_rank_fails():
    # Every rank raises inside the op; the parent gets each traceback, no hang.
    calls = [{"op": "no such op", "inputs": {"keys": np.zeros(2 * CFG.block, np.uint32)}}]
    with pytest.raises(RuntimeError, match="2 of 2 ranks failed(.|\n)*unknown op"):
        run_ranks(2, run_ops, (calls,), device="cpu", timeout=120.0)
