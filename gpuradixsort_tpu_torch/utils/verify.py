"""Result verification: the reference's is-sorted check, vectorized.

The PyTorch counterpart of ``gpuradixsort_tpu/utils/verify.py``: a host-side
sortedness check, the shuffled 0..N-1 permutation oracle, and a device-side
sortedness predicate; beside them the join's numpy oracle and keys whose
varying digits are chosen, for the fused sort's pass plan.
"""

from __future__ import annotations

import numpy as np
import torch

from gpuradixsort_tpu_torch.core.table import int32_bits


def _host(keys) -> np.ndarray:
    return keys.cpu().numpy() if isinstance(keys, torch.Tensor) else np.asarray(keys)


def is_sorted(keys, length: int | None = None) -> bool:
    """True iff keys[:length] is non-decreasing."""
    arr = _host(keys)
    if length is not None:
        arr = arr[:length]
    if arr.size <= 1:
        return True
    return bool(np.all(arr[1:] >= arr[:-1]))


def is_permutation_sorted(keys, n: int | None = None) -> bool:
    """The reference's demo oracle: sorted shuffled 0..N-1 == arange."""
    arr = _host(keys)
    if n is not None:
        arr = arr[:n]
    return bool(np.array_equal(arr, np.arange(arr.shape[0], dtype=arr.dtype)))


def device_is_sorted(keys: torch.Tensor) -> torch.Tensor:
    """Sortedness as a 0-d bool tensor on the keys' device (no readback).

    uint32 has no comparison in PyTorch, so its bits are widened to int64.
    """
    if keys.shape[0] <= 1:
        return torch.ones((), dtype=torch.bool, device=keys.device)
    wide = int32_bits(keys).to(torch.int64)
    if keys.dtype == torch.uint32:
        wide = wide & 0xFFFFFFFF
    return torch.all(wide[1:] >= wide[:-1])


def join_oracle(pk: np.ndarray, pv: np.ndarray, bk: np.ndarray, bv: np.ndarray):
    """The inner join in the distributed join's order, by numpy.

    Probe rows in key order, the probe order kept within a key; each followed
    by its key's build rows in build order.  Returns (keys, probe values,
    build values).
    """
    order_p = np.argsort(pk, kind="stable")
    order_b = np.argsort(bk, kind="stable")
    bks = bk[order_b]
    lo = np.searchsorted(bks, pk[order_p], side="left")
    cnt = np.searchsorted(bks, pk[order_p], side="right") - lo
    prow = np.repeat(order_p, cnt)
    first = np.repeat(np.cumsum(cnt) - cnt, cnt)
    brow = order_b[np.repeat(lo, cnt) + np.arange(prow.size) - first]
    return pk[prow], pv[prow], bv[brow]


def mask_keys(mask: int, n: int, cfg, gen: np.random.Generator) -> np.ndarray:
    """n keys whose digit p varies exactly where bit p of ``mask`` is set, drawn from ``gen``."""
    keys = np.full(n, 0x9C3A5E71, dtype=np.uint32)  # every digit constant
    digit = np.uint32(cfg.radix - 1)
    for p in range(cfg.num_passes):
        if (mask >> p) & 1:
            shift = np.uint32(p * cfg.radix_bits)
            vals = gen.integers(0, cfg.radix, n).astype(np.uint32)
            vals[:2] = (0, cfg.radix - 1)  # two values at least
            keys = (keys & ~(digit << shift)) | (vals << shift)
    return keys
