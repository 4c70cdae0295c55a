#!/usr/bin/env python3
"""Smoke gate of the PyTorch / CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the CUDA kernels of ``gpuradixsort_tpu_torch/csrc`` into
``build/kernels/`` (nvcc, sm_90a), then in four phases:

1. device: PyTorch version, the card's name and power limit, build time;
2. each kernel against its plain PyTorch version on the card, exact
   equality: radix_hist at radix_bits 1, 2, 4, 8; bucketize at 1, 2, 4;
   scatter_runs on the plain-bucketized input; each at shifts 0, 4 and 28,
   on 4 blocks of random keys and on 1,000,000 keys padded;
3. the main path through the public entry points on CUDA tensors, with every
   launch count set to 0 before and read after: ``sort_pairs`` of 1,000,000
   shuffled 0..N-1 keys (sorted keys == arange, permutation == numpy's stable
   argsort), of 2^20 shuffled keys (where the constant-digit skip fires), of
   2^24 random keys with duplicates, and ``sort_table`` of 1,000,000 rows of a
   key and 16 int32 payload columns (64-byte rows), every column checked;
4. times: fused sort against ``torch.sort(stable=True)`` at 1M and 16M keys
   (CUDA events, median of 7 runs after warm-up, and the device's busy time
   from torch.profiler); each kernel of one pass at 1M and 16M beside its
   plain version (device time from the profiler, and CUDA-event time per
   call); the 1M x 64 B table sort.

Exits non-zero at the first failure, including when no CUDA device is
present or a kernel's launch count stayed 0.  The line before the last is
the card's name and power limit; the last line is the JSON result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from gpuradixsort_tpu_torch.config import PAD_INDEX, EngineConfig
from gpuradixsort_tpu_torch.core.table import (
    Table,
    int32_bits,
    make_column,
    make_key_column,
    pad_to_tile,
)
from gpuradixsort_tpu_torch.kernels import _build
from gpuradixsort_tpu_torch.kernels import radix as rk
from gpuradixsort_tpu_torch.kernels.bucketize import _bucketize_ref, bucketize_tiles
from gpuradixsort_tpu_torch.kernels.scatter import scatter_runs
from gpuradixsort_tpu_torch.ops import sort as sort_ops
from gpuradixsort_tpu_torch.ops.sort import sort_pairs, sort_table
from gpuradixsort_tpu_torch.utils.timing import StageTimes, cuda_time_ms, profiled_device_ms
from gpuradixsort_tpu_torch.utils.verify import device_is_sorted, is_permutation_sorted

SEED = 20170101
N_HEADLINE = 1_000_000
PAYLOAD_COLS = 16
HBM_PEAK_TBS = 3.35  # H100 SXM data sheet

KERNELS = {
    "radix_hist": (rk.tile_histograms, "gpuradixsort_tpu_torch/csrc/radix_hist.cu",
                   "gpuradixsort_tpu/kernels/radix.py:57"),
    "bucketize": (bucketize_tiles, "gpuradixsort_tpu_torch/csrc/bucketize.cu",
                  "gpuradixsort_tpu/kernels/bucketize.py:156"),
    "scatter_runs": (scatter_runs, "gpuradixsort_tpu_torch/csrc/scatter_runs.cu",
                     "gpuradixsort_tpu/kernels/scatter.py:107"),
}


class SmokeFailure(Exception):
    pass


def log(msg: str) -> None:
    print(f"[smoke] {msg}", flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        log(f"FAIL  {what}")
        raise SmokeFailure(what)
    log(f"PASS  {what}")


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest |a - b| over two integer tensors of one shape, as unsigned."""
    if a.shape != b.shape:
        raise SmokeFailure(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    wide = [int32_bits(t).to(torch.int64) for t in (a, b)]
    if a.dtype == torch.uint32:
        wide = [w & 0xFFFFFFFF for w in wide]
    return int((wide[0] - wide[1]).abs().max()) if a.numel() else 0


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    return out.splitlines()[0]


def iota_index(n: int, cfg: EngineConfig, device) -> torch.Tensor:
    """0..n-1 as uint32, padded with PAD_INDEX as the sort pads its index."""
    iota = torch.arange(n, dtype=torch.int32, device=device).view(torch.uint32)
    return pad_to_tile(iota, cfg, PAD_INDEX)


def per_call_ms(fn, calls: int = 20, reps: int = 7) -> list[float]:
    """Per-call device ms of ``fn``: one sample per run of ``calls`` back-to-back calls."""
    def many():
        for _ in range(calls):
            fn()
    return [t / calls for t in cuda_time_ms(many, reps=reps, warmup=1)]


def median_per_call_ms(fn, calls: int = 20) -> float:
    return float(np.median(per_call_ms(fn, calls)))


def phase_kernels(dev, rng, errs: dict) -> None:
    """Phase 2: each kernel against its plain version, exact equality."""
    for label, n in (("4 blocks", 4 * EngineConfig().block), ("1M padded", N_HEADLINE)):
        keys_np = rng.integers(0, 2**32, size=n, dtype=np.uint32)
        for bits in (1, 2, 4, 8):
            cfg = EngineConfig(radix_bits=bits)
            keys = make_key_column(keys_np, cfg, device=dev).data
            idx = iota_index(n, cfg, dev)
            for shift in (0, 4, 28):
                where = f"{label} radix_bits={bits} shift={shift}"
                hist_ref = rk.tile_histograms(keys, shift, cfg, impl="reference")
                err = max_abs_err(rk.tile_histograms(keys, shift, cfg, impl="cuda"), hist_ref)
                errs["radix_hist"] = max(errs["radix_hist"], err)
                check(err == 0, f"radix_hist == plain, {where}")
                if cfg.radix > 16:
                    continue
                bk_ref, bi_ref = _bucketize_ref(keys, idx, shift, cfg)
                bk, bi = bucketize_tiles(keys, idx, shift, cfg, impl="cuda")
                err = max(max_abs_err(bk, bk_ref), max_abs_err(bi, bi_ref))
                errs["bucketize"] = max(errs["bucketize"], err)
                check(err == 0, f"bucketize == plain, {where}")
                offsets = rk.global_offsets(hist_ref)
                ok_ref, oi_ref, _ = scatter_runs(bk_ref, bi_ref, hist_ref, offsets, cfg,
                                                 impl="reference")
                ok, oi, overflow = scatter_runs(bk_ref, bi_ref, hist_ref, offsets, cfg,
                                                impl="cuda")
                err = max(max_abs_err(ok, ok_ref), max_abs_err(oi, oi_ref))
                errs["scatter_runs"] = max(errs["scatter_runs"], err)
                check(err == 0 and not overflow, f"scatter_runs == plain, {where}")
    torch.cuda.synchronize()


def phase_main_path(dev, rng, cfg) -> dict:
    """Phase 3: full sorts through the public entry points; returns launch counts."""
    perm_1m = rng.permutation(N_HEADLINE).astype(np.uint32)
    perm_2e20 = rng.permutation(1 << 20).astype(np.uint32)
    pool = rng.integers(0, 2**32, size=1 << 23, dtype=np.uint32)
    dup_16m = rng.choice(pool, size=1 << 24)  # about two copies of each key
    table_keys = rng.integers(0, 2**32, size=N_HEADLINE, dtype=np.uint32)
    payload = rng.integers(-2**31, 2**31, size=(N_HEADLINE, PAYLOAD_COLS), dtype=np.int64)
    payload = payload.astype(np.int32)
    table = Table({
        "key": make_key_column(table_keys, cfg, device=dev),
        **{f"p{j}": make_column(payload[:, j], cfg, device=dev) for j in range(PAYLOAD_COLS)},
    })
    torch.cuda.synchronize()

    for fn, _, _ in KERNELS.values():
        fn.launches = 0
    sort_ops._fused_sort_padded.skipped_passes = 0
    results = {}
    for name, keys_np in (("1M shuffled", perm_1m), ("2^20 shuffled", perm_2e20),
                          ("2^24 random with duplicates", dup_16m)):
        skipped = sort_ops._fused_sort_padded.skipped_passes
        s, p = sort_pairs(keys_np, cfg, method="fused", device=dev)
        results[name] = (s.to_numpy(), p.to_numpy(), bool(device_is_sorted(s.valid())),
                         sort_ops._fused_sort_padded.skipped_passes - skipped)
    skipped = sort_ops._fused_sort_padded.skipped_passes
    sorted_table = sort_table(table, "key", cfg, method="fused")
    table_out = {k: sorted_table[k].to_numpy() for k in sorted_table.names()}
    table_skipped = sort_ops._fused_sort_padded.skipped_passes - skipped
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, (fn, _, _) in KERNELS.items()}

    for name, keys_np in (("1M shuffled", perm_1m), ("2^20 shuffled", perm_2e20),
                          ("2^24 random with duplicates", dup_16m)):
        s, p, dev_sorted, skipped = results[name]
        order = np.argsort(keys_np, kind="stable")
        log(f"{name}: {skipped} of {cfg.num_passes} passes skipped (constant digit)")
        check(dev_sorted, f"sort_pairs {name}: device_is_sorted")
        if "shuffled" in name:
            check(is_permutation_sorted(s), f"sort_pairs {name}: keys == arange")
        check(np.array_equal(s, keys_np[order]), f"sort_pairs {name}: keys == np.sort")
        check(np.array_equal(p, order.astype(np.uint32)),
              f"sort_pairs {name}: permutation == np.argsort(kind='stable')")
    order = np.argsort(table_keys, kind="stable")
    log(f"sort_table 1M x 64B: {table_skipped} of {cfg.num_passes} passes skipped")
    check(np.array_equal(table_out["key"], table_keys[order]), "sort_table key column")
    check(all(np.array_equal(table_out[f"p{j}"], payload[order, j])
              for j in range(PAYLOAD_COLS)),
          f"sort_table all {PAYLOAD_COLS} payload columns == payload[argsort]")
    for name, count in launches.items():
        check(count > 0, f"{name} launched {count} times on the main path")
    return launches


def _kernel_name(row: str) -> str:
    """The port's kernel a profiler row names (``<name>_kernel`` in csrc/), or ''."""
    return next((name for name in KERNELS if f"{name}_kernel(" in row), "")


def phase_times(dev, rng, cfg, card: str) -> dict:
    """Phase 4: times; returns per-kernel (device ms, plain device ms) at 1M."""
    for n, label in ((N_HEADLINE, "1M"), (1 << 24, "16M")):
        col = make_key_column(rng.integers(0, 2**32, size=n, dtype=np.uint32), cfg,
                              device=dev)
        fused = lambda: sort_pairs(col, cfg, method="fused")  # noqa: E731
        t_fused = median_per_call_ms(fused, calls=1)
        t_torch = median_per_call_ms(lambda: sort_pairs(col, cfg, method="torch"), calls=1)
        flipped = int32_bits(col.data) ^ torch.iinfo(torch.int32).min
        t_raw = median_per_call_ms(lambda: torch.sort(flipped, stable=True), calls=1)
        log(f"time {label} ({col.padded_length} padded keys, {card}), CUDA events, "
            f"median of 7: sort_pairs fused {t_fused:.4f} ms ({n / t_fused / 1e3:.1f} M "
            f"keys/s); sort_pairs torch (torch.sort of int64-widened keys + gathers) "
            f"{t_torch:.4f} ms; bare torch.sort of sign-flipped int32 keys {t_raw:.4f} ms")
        busy, rows = profiled_device_ms(fused, calls=3)
        if not busy:
            log(f"  profiler, fused {label}: device time not measured")
            continue
        ours = {_kernel_name(k): v for k, v in rows.items() if _kernel_name(k)}
        split = ", ".join(f"{k} {v:.4f}" for k, v in ours.items())
        log(f"  profiler, fused {label}: device busy {busy:.4f} ms per sort ({split}, "
            f"other torch kernels {busy - sum(ours.values()):.4f}); busy share of the "
            f"event time {busy / t_fused:.3f}")

    times = {}
    for n, label in ((N_HEADLINE, "1M"), (1 << 24, "16M")):
        keys = make_key_column(rng.integers(0, 2**32, size=n, dtype=np.uint32), cfg,
                               device=dev).data
        idx = iota_index(n, cfg, dev)
        hist = rk.tile_histograms(keys, 0, cfg)
        offsets = rk.global_offsets(hist)
        bk, bi = bucketize_tiles(keys, idx, 0, cfg)
        padded = keys.numel()
        stage = {  # name: (kernel, plain, HBM bytes the kernel must move)
            "radix_hist": (lambda: rk.tile_histograms(keys, 0, cfg, impl="cuda"),
                           lambda: rk.tile_histograms(keys, 0, cfg, impl="reference"),
                           4 * padded),
            "bucketize": (lambda: bucketize_tiles(keys, idx, 0, cfg, impl="cuda"),
                          lambda: bucketize_tiles(keys, idx, 0, cfg, impl="reference"),
                          16 * padded),
            "scatter_runs": (lambda: scatter_runs(bk, bi, hist, offsets, cfg, impl="cuda"),
                             lambda: scatter_runs(bk, bi, hist, offsets, cfg,
                                                  impl="reference"),
                             16 * padded),
        }
        st = StageTimes()
        log(f"one pass at {label} keys, shift 0, radix 16 ({card}): device time "
            f"(profiler) and per-call time of 20 back-to-back calls (CUDA events)")
        for name, (kernel, plain, nbytes) in stage.items():
            # Alternating turns, so both sides see the same card state; the
            # median over turns in which the profiler recorded device time.
            turns = {"k": [], "p": []}
            for side in "kppkkp":
                fn = kernel if side == "k" else plain
                turns[side].append(profiled_device_ms(fn, calls=20)[0])
            dev_k, dev_p = (float(np.median([t for t in turns[side] if t] or [0.0]))
                            for side in "kp")
            wall_k, wall_p = median_per_call_ms(kernel), median_per_call_ms(plain)
            if label == "1M":  # CUDA-event time where the profiler saw nothing
                times[name] = (dev_k or wall_k, dev_p or wall_p)
            st.add(f"{name} kernel device", dev_k / 1e3)
            st.add(f"{name} kernel per call", wall_k / 1e3)
            st.add(f"{name} plain device", dev_p / 1e3)
            st.add(f"{name} plain per call", wall_p / 1e3)
            if dev_k:
                rate = nbytes / (dev_k * 1e-3) / 1e12
                log(f"  {name}: {nbytes / 1e6:.1f} MB at {rate:.3f} TB/s, "
                    f"{rate / HBM_PEAK_TBS:.3f} of the 3.35 TB/s peak")
            if name == "radix_hist":
                st.add("global_offsets device", profiled_device_ms(
                    lambda: rk.global_offsets(hist), calls=20)[0] / 1e3)
                st.add("global_offsets per call",
                       median_per_call_ms(lambda: rk.global_offsets(hist)) / 1e3)
        for line in st.report().splitlines():
            log("  " + line)

    keys_np = rng.integers(0, 2**32, size=N_HEADLINE, dtype=np.uint32)
    payload = rng.integers(-2**31, 2**31, size=(N_HEADLINE, PAYLOAD_COLS), dtype=np.int64)
    payload = payload.astype(np.int32)
    table = Table({
        "key": make_key_column(keys_np, cfg, device=dev),
        **{f"p{j}": make_column(payload[:, j], cfg, device=dev) for j in range(PAYLOAD_COLS)},
    })
    t_table = median_per_call_ms(lambda: sort_table(table, "key", cfg, method="fused"),
                                 calls=1)
    log(f"time sort_table 1M rows x 64 B (key + 16 int32 columns, {card}), CUDA events, "
        f"median of 7: {t_table:.4f} ms ({N_HEADLINE / t_table / 1e3:.1f} M rows/s)")
    return times


def main() -> int:
    if not torch.cuda.is_available():
        log("FAIL no CUDA device: torch.cuda.is_available() is False")
        return 1
    dev = torch.device("cuda", 0)
    cfg = EngineConfig()
    rng = np.random.default_rng(SEED)
    card = card_line()
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; card: {card}; "
        f"device count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    lib = _build.library()
    log(f"kernels built and loaded in {time.perf_counter() - t0:.2f} s: {lib._name}")

    errs = {name: 0 for name in KERNELS}
    phase_kernels(dev, rng, errs)
    launches = phase_main_path(dev, rng, cfg)
    times = phase_times(dev, rng, cfg, card)

    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": replaces,
         "launches": launches[name], "max_abs_err": errs[name],
         "ms": times[name][0], "plain_ms": times[name][1]}
        for name, (_, src, replaces) in KERNELS.items()
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
