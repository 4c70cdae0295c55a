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


def _ordered_bits(t: torch.Tensor) -> torch.Tensor:
    """float32 bits as int64 on one line: a step of 1 is one ulp, -0.0 and +0.0 meet."""
    bits = t.view(torch.int32).to(torch.int64)
    return torch.where(bits < 0, -(bits & 0x7FFFFFFF), bits)


def aggregate_errors(got, want) -> dict[str, tuple[float, int]]:
    """How far the group-by result ``got`` lies from ``want``, output by output.

    Each is ``(group_keys, {name: values}, count)`` as ``segment_aggregate``
    returns it.  Returns {name: (max abs error, float32 ulps)} for every
    output, "keys" and "count" among them.  Integer outputs compare their
    values (uint32 unsigned) and count no ulps.  Float outputs compare
    their numbers, and a NaN must stand where the other holds one: a NaN
    against a number counts as an infinite error and 2^32 ulps.
    """
    pairs = {"keys": (got[0], want[0]), "count": (got[2], want[2]),
             **{name: (got[1][name], v) for name, v in want[1].items()}}
    errs = {}
    for name, (g, w) in pairs.items():
        if g.dtype != w.dtype or g.shape != w.shape:
            raise ValueError(f"{name}: {g.dtype} {tuple(g.shape)} against {w.dtype} "
                             f"{tuple(w.shape)}")
        g, w = g.cpu(), w.cpu()
        if g.dtype != torch.float32:
            wide = [int32_bits(t).to(torch.int64) for t in (g, w)]
            if g.dtype == torch.uint32:
                wide = [t & 0xFFFFFFFF for t in wide]
            err = int((wide[0] - wide[1]).abs().max()) if g.numel() else 0
            errs[name] = (float(err), 0)
            continue
        nan = torch.isnan(g)
        if not torch.equal(nan, torch.isnan(w)):
            errs[name] = (float("inf"), 2**32)
            continue
        g, w = g[~nan], w[~nan]
        if not g.numel():
            errs[name] = (0.0, 0)
            continue
        abs_err = float((g.to(torch.float64) - w.to(torch.float64)).abs().max())
        ulps = int((_ordered_bits(g) - _ordered_bits(w)).abs().max())
        errs[name] = (abs_err, ulps)
    return errs
