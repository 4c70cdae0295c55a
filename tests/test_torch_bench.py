"""The port's bench module against the repo's ``bench.py`` and numpy, on the CPU.

``bench.py`` is imported with JAX on the CPU (``tests/conftest.py``); the
port's bench runs on CPU tensors, where it checks every result and times
nothing.  Its run on the card is in ``tests/test_torch_cuda.py``.
"""

import json
import os
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench as jbench
from gpuradixsort_tpu import config as jconfig
from gpuradixsort_tpu.ops import sort as jsort
from gpuradixsort_tpu_torch import bench as tbench
from gpuradixsort_tpu_torch.config import EngineConfig
from gpuradixsort_tpu_torch.utils.timing import bound_of

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
CFG = EngineConfig()
JCFG = jconfig.EngineConfig()
N = 3 * CFG.block + 1


@pytest.fixture(scope="module")
def inputs():
    """The port's inputs at N keys from the bench's seed: (keys_np, keys, idx, order)."""
    keys_np, keys, idx = tbench.make_inputs(N, CFG, np.random.default_rng(tbench.SEED), "cpu")
    return keys_np, keys, idx, np.argsort(keys_np, kind="stable")


def test_make_inputs_match_bench_py():
    # Two draws in turn from the same seed: raw keys, padded keys and index.
    jrng, trng = np.random.default_rng(tbench.SEED), np.random.default_rng(tbench.SEED)
    for n in (N, N + 5):
        jkeys_np, jkeys, jidx = jbench.make_inputs(n, JCFG, jrng)
        keys_np, keys, idx = tbench.make_inputs(n, CFG, trng, "cpu")
        np.testing.assert_array_equal(keys_np, jkeys_np)
        np.testing.assert_array_equal(keys.numpy(), np.asarray(jkeys))
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        assert keys.numel() == 4 * CFG.block and keys.dtype == idx.dtype == torch.uint32


# The port's method -> the bench.py method it stands for, whose padded
# output it must equal (None: bench.py's fused sort runs Pallas kernels).
JAX_METHOD = {"torch": "xla", "fused": None, "radix": "radix"}


@pytest.mark.parametrize("method", tbench.methods_for(tbench.HEADLINE_N))
def test_methods_pass_checks_and_agree_with_bench_py(method, inputs):
    keys_np, keys, idx, order = inputs
    out_keys, out_idx = tbench.sort_padded(method, keys, idx, CFG)
    assert tbench.pairs_match(out_keys, out_idx, keys_np, order)
    jmethod = JAX_METHOD[method]
    if jmethod is None:
        return
    jkeys, jidx = jnp.asarray(keys.numpy()), jnp.asarray(idx.numpy())
    assert jbench.verify_method(jmethod, JCFG, jkeys, jidx, keys_np, N)
    if jmethod == "radix":
        js, (jp,) = jsort._sort_padded(jkeys, (jidx,), JCFG, None, 1)
    else:
        js, (jp,) = jsort._xla_sort_padded(jkeys, (jidx,))
    np.testing.assert_array_equal(out_keys.numpy(), np.asarray(js))
    np.testing.assert_array_equal(out_idx.numpy(), np.asarray(jp))


def test_pair_check_fails_on_a_wrong_permutation(inputs):
    keys_np, keys, idx, order = inputs
    out_keys, out_idx = tbench.sort_padded("torch", keys, idx, CFG)
    swapped = out_idx.view(torch.int32).clone()
    swapped[[5, 6]] = swapped[[6, 5]]  # keys still sorted, permutation wrong
    swapped = swapped.view(torch.uint32)
    assert not tbench.pairs_match(out_keys, swapped, keys_np, order)


def test_table_sort_check_fails_on_a_corrupted_row(inputs):
    keys_np, keys, idx, order = inputs
    payload_np = np.random.default_rng(1).integers(
        0, 2**31, (keys.numel(), tbench.PAYLOAD_COLS), dtype=np.int64).astype(np.int32)
    rows = tbench.table_sort(keys, idx, torch.from_numpy(payload_np), CFG)
    assert tbench.rows_match(rows, payload_np, order)
    bad = rows.clone()
    bad[N // 2, 7] ^= 1
    assert not tbench.rows_match(bad, payload_np, order)
    pad = rows.clone()
    pad[N:] = 0  # pad rows lie past the live prefix, which alone is checked
    assert tbench.rows_match(pad, payload_np, order)


def test_stage_bytes_equal_hand_counts():
    # 2 blocks: 16,384 keys in 16 tiles of 1,024; a radix-16 table is
    # 16 x 16 int32 = 1,024 bytes, a radix-256 one 16,384.
    padded = 2 * CFG.block
    # sort_plan: the keys, the AND and OR, the plan (8 int32), counts and
    # bases (2 x 8 x 16 int32), the 128-byte lines it sums the counts in
    # (128 of them and one for the AND, the OR and the finished blocks),
    # the look-back's words (4 partitions of 4,096 keys x 16 digits x 8
    # bytes, and a 4-byte ticket a pass); the look-back pass writes and
    # reads its pass's status words; sort_args writes its five 8-byte words;
    # dest_scatter reads two tables and moves a key, which it also ranks,
    # and its index (2 x 8 bytes a row), or five 4-byte words a row.
    assert tbench.stage_work(padded, CFG) == {
        "sort_args": (40, 0),
        "sort_plan": (4 * 16384 + 8 + 32 + 1024 + 4 * 4128 + 512 + 4 * 8, 10 * 16384),
        "bucketize_scatter_lookback": (16 * 16384 + 2 * 512, 6 * 16384),
        "radix_hist": (4 * 16384 + 1024, 3 * 16384),
        "global_offsets": (2048, 256),
        "bucketize": (16 * 16384, 4 * 16384),
        "scatter_runs": (16 * 16384 + 2048, 2 * 16384),
        "bucketize_scatter": (16 * 16384 + 1024, 6 * 16384),
        "radix_dest": (8 * 16384 + 1024, 4 * 16384),
        "dest_scatter": (16 * 16384 + 2048, 4 * 16384),
        "exclusive_scan": (8 * 16384 + 4, 16384),
        "key_bits": (4 * 16384 + 8, 2 * 16384),
        "gather_rows": ((4 + 64 + 64) * 16384, 0),
    }
    assert tbench.stage_work(padded, CFG, words=5)["dest_scatter"] == (
        40 * 16384 + 2048, 4 * 16384)
    assert tbench.stage_work(padded, EngineConfig(radix_bits=8))["scatter_runs"] == (
        16 * 16384 + 2 * 16384, 2 * 16384)
    assert bound_of(3_350_000_000, 0) == pytest.approx((1.0, "bytes"))
    assert bound_of(0, 67_000_000_000) == pytest.approx((1.0, "operations"))


def test_stage_table_untimed_on_cpu(inputs):
    _, keys, _, _ = inputs
    rows = tbench.stage_table(keys, CFG, timed=False)
    work = tbench.stage_work(keys.numel(), CFG)
    assert [r["stage"] for r in rows] == list(tbench.STAGES)
    for r, name in zip(rows, tbench.STAGES.values()):
        assert r["bytes"] == work[name][0]
        assert r["bound_ms"] == bound_of(*work[name])[0]
        assert r["event_ms"] is None and r["device_ms"] is None and r["share"] is None
    text = tbench.stage_text(rows, "cpu: nothing timed", N, keys.numel())
    assert text.splitlines()[0] == "cpu: nothing timed"
    assert "scatter_runs kernel (per pass)" in text and "window" not in text
    assert "bucketize+scatter kernel (per pass)" in text
    assert "not measured per launch by events" in text


@pytest.mark.parametrize("fault", ["wrong result", "raises"])
def test_a_faulty_method_fails_the_bench(fault, tmp_path, monkeypatch):
    sort_padded = tbench.sort_padded

    def faulty(method, keys, idx, cfg):
        out_keys, out_idx = sort_padded(method, keys, idx, cfg)
        if method != "fused":
            return out_keys, out_idx
        if fault == "raises":
            raise RuntimeError("fused sort failed")
        return out_keys, torch.flip(out_idx.view(torch.int32), [0]).view(torch.uint32)

    monkeypatch.setattr(tbench, "sort_padded", faulty)
    error = tbench.BenchFailure if fault == "wrong result" else RuntimeError
    with pytest.raises(error):
        tbench.main(["--device", "cpu", "--sizes", "2048", "--out", str(tmp_path)])


def _bench(*args, cwd=REPO):
    return subprocess.run([sys.executable, "-m", "gpuradixsort_tpu_torch.bench", *args],
                          capture_output=True, text=True, timeout=300, cwd=cwd,
                          env={**os.environ, "OMP_NUM_THREADS": "1"})


def test_bench_on_cpu_ends_with_one_json_line(tmp_path):
    done = _bench("--device", "cpu", "--sizes", "16384", "--out", str(tmp_path))
    assert done.returncode == 0, done.stderr
    lines = done.stdout.splitlines()
    assert len(lines) == 1
    line = json.loads(lines[-1])
    assert line["value"] is None and line["vs_baseline"] is None and line["unit"] == "keys/s"
    assert line["device"] == {"name": "cpu", "power_limit": None}
    for method in tbench.methods_for(16384):
        assert f"PASS  n=16384 {method}:" in done.stderr
    assert "PASS  n=16384 table sort" in done.stderr
    durations = (tmp_path / tbench.DURATIONS_FILE).read_text().splitlines()
    assert durations[0] == "cpu: nothing timed" and len(durations) == 3 + len(tbench.STAGES)
    assert not (tmp_path / "durations_tpu.txt").exists()


def test_bench_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    done = _bench("--sizes", "16384", "--out", str(tmp_path))
    assert done.returncode != 0
    assert "no CUDA card" in done.stderr and done.stdout == ""
    assert not (tmp_path / tbench.DURATIONS_FILE).exists()
