"""Entry points: one fused sort, and a multi-rank dryrun of the distributed layer.

The PyTorch counterpart of ``__graft_entry__.py``.

    python -m gpuradixsort_tpu_torch.entry [--device cpu]

runs ``entry()``'s sort once and checks it, then ``dryrun_multichip(4)``:
four NCCL ranks on a machine with four cards, four gloo ranks on card 0
otherwise.  Both run on the CUDA card unless ``--device cpu`` is given, and
raise where there is no card.  Unlike the JAX dryrun, which covers the sort
and the aggregate, this one also runs ``dist_join_inner``.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from gpuradixsort_tpu_torch.config import PAD_INDEX, EngineConfig, default_device
from gpuradixsort_tpu_torch.core.table import make_key_column, pad_to_tile
from gpuradixsort_tpu_torch.ops.sort import _fused_sort_padded
from gpuradixsort_tpu_torch.parallel.launch import run_ops, run_ranks
from gpuradixsort_tpu_torch.utils.verify import join_oracle


def entry(device=None):
    """(fn, example_args): one fused stable sort of (key, index) pairs, 64 blocks.

    Every pass runs the histogram, offsets-scan, bucketize and scatter
    kernels on a CUDA device (their plain versions on the CPU).  ``device``
    defaults to the CUDA card, as the JAX entry takes JAX's default backend;
    without a card it raises unless ``device="cpu"``.
    """
    device = default_device(device)
    cfg = EngineConfig()
    n = 64 * cfg.block
    rng = np.random.default_rng(0)
    keys = make_key_column(rng.integers(0, 2**32, size=n, dtype=np.uint32), cfg,
                           device=device).data
    iota = torch.arange(n, dtype=torch.int32, device=device).view(torch.uint32)
    idx = pad_to_tile(iota, cfg, PAD_INDEX)

    def fn(keys, idx):
        sorted_keys, perm, _overflow = _fused_sort_padded(keys, idx, cfg)
        return sorted_keys, perm

    return fn, (keys, idx)


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"dryrun: {what}")


def dryrun_multichip(n_devices: int, timeout: float = 300.0, device=None) -> dict:
    """One distributed sort, aggregate and join over ``n_devices`` ranks, checked by numpy.

    Runs the scale-out path: per-shard local radix sort, the all-reduced
    bucket histogram, the balanced repartition, the all_to_all exchange,
    the merge and the pad repair, on small shapes.  ``device`` defaults to
    the CUDA card.  With ``n_devices`` cards the ranks are NCCL ranks, one
    card each (the JAX dryrun likewise takes the devices JAX has); with
    fewer, gloo ranks that share the card, every collective staged through
    pinned host memory.  Without a card it raises unless ``device="cpu"``,
    which runs gloo ranks on the CPU.  Returns rank 0's result of each op.
    """
    dev = default_device(device)
    if dev.type == "cuda" and torch.cuda.device_count() >= n_devices:
        where, backend = "cuda", "nccl"
    else:
        where, backend = str(dev), "gloo"
    cfg = EngineConfig()
    rng = np.random.default_rng(1)
    n = n_devices * cfg.block  # one block per rank: no padding
    keys = rng.integers(0, 2**32, size=n, dtype=np.uint32)
    gk = rng.integers(0, 64, size=n, dtype=np.uint32)
    gv = rng.integers(0, 100, size=n).astype(np.int32)
    pk = rng.integers(0, n, size=n, dtype=np.uint32)  # about one match per probe row
    bk = rng.integers(0, n, size=n, dtype=np.uint32)
    pv = rng.integers(0, 2**31 - 1, size=n, dtype=np.int32)
    bv = rng.integers(0, 2**31 - 1, size=n, dtype=np.int32)
    calls = [
        {"op": "sort", "inputs": {"keys": keys},
         "kwargs": {"cfg": cfg, "n_live": n}, "gather": True},
        {"op": "aggregate", "inputs": {"keys": gk, "values": {"v": gv}},
         "kwargs": {"aggs": {"s": ("v", "sum")}, "cfg": cfg, "n_live": n}, "gather": True},
        {"op": "join", "inputs": {"probe_keys": pk, "probe_values": pv,
                                  "build_keys": bk, "build_values": bv},
         "kwargs": {"cfg": cfg, "n_probe": n, "n_build": n}, "gather": True},
    ]
    sort, agg, joined = run_ranks(n_devices, run_ops, (calls,), backend, where, timeout)[0]

    out_k, out_i = sort["gathered"]
    _require(np.array_equal(out_k, np.sort(keys)), "sorted keys differ from np.sort")
    _require(np.array_equal(out_i, np.argsort(keys, kind="stable").astype(np.uint32)),
             "sort index differs from the stable argsort")
    gkeys, gvals = agg["gathered"]
    uniq, inverse = np.unique(gk, return_inverse=True)
    sums = np.bincount(inverse, weights=gv, minlength=uniq.size).astype(np.int64)
    _require(np.array_equal(gkeys, uniq), "group keys differ from np.unique")
    _require(np.array_equal(gvals["s"], sums.astype(np.int32)), "group sums differ")
    got = joined["gathered"]
    want = join_oracle(pk, pv, bk, bv)
    _require(all(np.array_equal(g, w) for g, w in zip(got, want)),
             f"join rows differ ({got[0].size} against {want[0].size})")
    return {"sort": sort, "aggregate": agg, "join": joined}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="where to run (default: the CUDA card; 'cpu' runs on the CPU)")
    device = parser.parse_args().device
    fn, args = entry(device)
    sorted_keys, perm = fn(*args)
    keys = args[0].cpu().numpy()
    ok = (np.array_equal(sorted_keys.cpu().numpy(), np.sort(keys))
          and np.array_equal(perm.cpu().numpy(), np.argsort(keys, kind="stable")))
    if not ok:
        raise SystemExit("entry() sort differs from numpy")
    print(f"entry() sorted {keys.size} keys on {args[0].device}")
    out = dryrun_multichip(4, device=device)
    print(f"dryrun_multichip(4) OK: sort, aggregate and join over 4 ranks, "
          f"transport {out['sort']['transport']}")
