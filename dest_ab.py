#!/usr/bin/env python3
"""Time dest_scatter beside its partition sizes, a variant and an older build, on one CUDA card.

    python3 dest_ab.py [--old DIR] [--out FILE]

``dest_scatter`` (``csrc/radix_dest.cu``) is one radix pass's moves: K4's
destinations and the indexed stores after them, in one kernel in which a
block ranks a partition of consecutive tiles, stages its permutation in
shared memory and writes each digit's rows of the partition as one run.
This script builds, each into a library of its own under
``build/kernels_ab/``:

- ``port``: ``csrc/radix_dest.cu`` as it stands, launched at the geometry
  its wrapper picks (``kernels/radix.py::dest_scatter_geometry``) and at
  every partition of 1, 2, 4 and 8 tiles (``P=...``; one warp a tile, a
  block one partition, or 4 partitions of one tile);
- ``match_any``: the same with the rank above radix 32 taking each key's
  peers from ``__match_any_sync`` in place of one ballot a digit bit, at
  the wrapper's geometry, radix 256 only;
- ``rank batch 16``: the same with 16 keys a lane loaded before they are
  ranked, in place of 32, at the wrapper's geometry;

and, with ``--old DIR`` (a directory holding an older ``radix_dest.cu`` and
its headers, e.g. ``chip_scratch/parent/gpuradixsort_tpu_torch/csrc`` from
``git archive <parent> gpuradixsort_tpu_torch/csrc | tar -x -C
chip_scratch/parent``, whose entry point takes no partition size and whose
block is four independent warps, one a tile), ``parent``.

Each is timed beside K4 then ``scatter_by_destination`` (the plain stores
it replaces) on the same input: (key, index) pairs as a radix pass moves
them at 1,000,000, 2^24 and 100,000,000 keys, radix 2, 16 and 256, and the
filter's compaction of 100,000,000 rows (1-bit digits of a mask, one
uint32 column moved).  Device time per call from torch.profiler (20
back-to-back calls, median of 3 turns in alternating order), the bound (the
bytes at 3.35 TB/s: ``bench.stage_work``'s, plus the digits read where they
are not a moved column) and the share of it.  With ``--old`` also the
radix method's ``sort_pairs`` at radix_bits 8 and 4, at 2^24 and
100,000,000 keys, through each build (the wrapper's ``launch`` routed to
it; eager, so that no graph replays another build's kernel), by CUDA
events in turns parent, port, port, parent, and by the profiler's device
busy time a sort (the eager 2^24 sorts are paced by the host); and
``chip_smoke.py``'s 100M ``filter_table`` + ``to_table`` (keys below 2^31
kept) and its inner ``join`` + ``to_table`` of 100M probe rows against 10M
unique build keys (power-law hits, 10% misses), through each build, by
CUDA events in the same turns.  Every output is checked equal to the
plain version, every sort and operator to the other build's.  nvcc's
register and spill report of each build is printed.  The card's name and
power limit and one JSON line of every number end the output; ``--out``
also writes that JSON to a file.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import re
import subprocess
import sys
from unittest import mock

import numpy as np
import torch

from gpuradixsort_tpu_torch.bench import stage_work
from gpuradixsort_tpu_torch.config import EngineConfig
from gpuradixsort_tpu_torch.core.table import Table, int32_bits, make_column, make_key_column
from gpuradixsort_tpu_torch.kernels import _build
from gpuradixsort_tpu_torch.kernels import radix as rk
from gpuradixsort_tpu_torch.ops import sort as sort_ops
from gpuradixsort_tpu_torch.ops.filter import filter_table
from gpuradixsort_tpu_torch.ops.join import join
from gpuradixsort_tpu_torch.ops.permute import scatter_by_destination
from gpuradixsort_tpu_torch.utils.timing import bound_of, card_line, per_call_ms, profiled_device_ms

SEED = 20170101
REPO = pathlib.Path(__file__).resolve().parent
AB_BUILD = REPO / "build" / "kernels_ab"
PORT_CSRC = REPO / "gpuradixsort_tpu_torch" / "csrc"
PARTITIONS = (1, 2, 4, 8)
OLD_THREADS = 128  # the parent's block: four warps, one a tile

# The match_any variant's rank: above radix 32 no ballots, the peers from one match.
BALLOT_RANK = """          const grs::DigitBallots<kBits> ballots(d, kBits);
          const unsigned peers = ballots.lanes_with(d, kBits);"""
MATCH_RANK = """          constexpr bool kBallots = kRadix <= kRegisterRadix;
          const grs::DigitBallots<kBallots ? kBits : 1> ballots(d, kBallots ? kBits : 0);
          const unsigned peers = kBallots ? ballots.lanes_with(d, kBits)
                                          : __match_any_sync(grs::kFullWarp, d);"""


def variants(old: pathlib.Path | None) -> dict[str, tuple[str, pathlib.Path]]:
    """Each build's name, its source text and its include directory."""
    port = (PORT_CSRC / "radix_dest.cu").read_text()
    match = port.replace(BALLOT_RANK, MATCH_RANK)
    batch = port.replace("constexpr int kRankBatch = 32;", "constexpr int kRankBatch = 16;")
    if match == port or batch == port:
        raise RuntimeError("csrc/radix_dest.cu no longer has the lines the variants replace")
    out = {"port": (port, PORT_CSRC), "match_any": (match, PORT_CSRC),
           "rank batch 16": (batch, PORT_CSRC)}
    if old is not None:
        out["parent"] = ((old / "radix_dest.cu").read_text(), old)
    return out


def build_all(old: pathlib.Path | None) -> tuple[dict, dict]:
    """Compile every build at once; returns (loaded libraries, ptxas lines by build)."""
    AB_BUILD.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for i, (name, (text, inc)) in enumerate(variants(old).items()):
        src = AB_BUILD / f"dest_variant{i}.cu"
        src.write_text(text)
        lib = AB_BUILD / f"dest_variant{i}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(inc), "-shared", "-Xptxas", "-v",
               "-o", str(lib), str(src)]
        jobs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    libs, reports = {}, {}
    kernel = re.compile(r"Function properties for \S*dest_scatter_kernelILi(\d)E")
    for name, (lib, proc) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        lines = out.splitlines()
        reports[name] = [
            f"radix {1 << int(m.group(1))}: " + lines[i + 1].strip() + "; "
            + lines[i + 2].split(":", 1)[1].strip()
            for i, line in enumerate(lines) if (m := kernel.search(line))]
        handle = ctypes.CDLL(str(lib))
        fn = handle.grs_radix_dest_scatter
        sig = _build._SIGNATURES["grs_radix_dest_scatter"]
        fn.argtypes = sig[:8] + sig[9:] if name == "parent" else sig  # no partition size
        fn.restype = ctypes.c_int
        libs[name] = handle
    return libs, reports


def call_entry(lib, parent: bool, keys, hist, offsets, words, ncols: int, cfg, geometry):
    """One launch of ``lib``'s entry point; ``geometry`` is (threads, tiles a partition),
    none for the parent's."""
    num_tiles = keys.numel() // cfg.tile
    shape = (OLD_THREADS,) if parent else geometry
    err = lib.grs_radix_dest_scatter(
        keys.data_ptr(), hist.data_ptr(), offsets.data_ptr(), words, ncols, num_tiles, cfg.tile,
        *shape, 0, cfg.radix, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"grs_radix_dest_scatter: CUDA error {err}")


def launcher(lib, parent: bool, keys, hist, offsets, cfg, columns, outs, geometry):
    """A launch of ``lib`` moving ``columns`` (4-byte words) into ``outs``."""
    words = (ctypes.c_int64 * (4 * len(columns)))(
        *(w for c, o in zip(columns, outs) for w in (c.data_ptr(), o.data_ptr(), 1, 4)))

    def run():
        call_entry(lib, parent, keys, hist, offsets, ctypes.addressof(words), len(columns), cfg,
                   geometry)
        return outs
    return run


def routed(lib, parent: bool):
    """The port's ``launch`` with every dest_scatter launch sent to ``lib``."""
    def launch(name, like, *args):
        if name != "grs_radix_dest_scatter":
            return _build.launch(name, like, *args)
        keys, hist, offsets, words, ncols, num_tiles, tile, threads, per_block, shift, radix = args
        shape = (OLD_THREADS,) if parent else (threads, per_block)
        err = lib.grs_radix_dest_scatter(keys, hist, offsets, words, ncols, num_tiles, tile,
                                         *shape, shift, radix,
                                         torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"grs_radix_dest_scatter: CUDA error {err}")
    return launch


def cases(rng, dev):
    """(label, rank keys, columns moved, cfg, bytes of the bound) of each case."""
    for label, n in (("1M", 1_000_000), ("2^24", 1 << 24), ("100M", 100_000_000)):
        keys = make_key_column(rng.integers(0, 2**32, n, dtype=np.uint32), EngineConfig(),
                               device=dev).data
        idx = torch.arange(keys.numel(), dtype=torch.int32, device=dev)
        for bits in (1, 4, 8):
            cfg = EngineConfig(radix_bits=bits)
            yield (f"(key, index) @ {label}, radix {cfg.radix}", keys, [keys.view(torch.int32), idx],
                   cfg, stage_work(keys.numel(), cfg)["dest_scatter"][0])
        del idx
    mask = torch.from_numpy(rng.integers(0, 2, keys.numel()).astype(np.int32)).to(dev)
    digits = (1 - mask).view(torch.uint32)
    cfg = EngineConfig(radix_bits=1)
    yield ("compaction @ 100M, 1-bit digits, one column", digits, [keys.view(torch.int32)], cfg,
           4 * keys.numel() + stage_work(keys.numel(), cfg, words=1)["dest_scatter"][0])


def forced_threads(cfg, per_block: int) -> int:
    """The threads of a block of partitions of ``per_block`` tiles, as the wrapper makes it."""
    part = rk.dest_scatter_partition_bytes(cfg.radix, cfg.tile, per_block)
    if per_block > 1:
        return rk.WARP * per_block
    return rk.WARP * min(rk.DEST_SCATTER_BLOCK_WARPS, rk.MAX_SHARED_BYTES // part)


def time_cases(libs, rng, dev, card: str) -> dict:
    """Every case through every build and partition size; returns their numbers by case."""
    results = {}
    for label, keys, columns, cfg, nbytes in cases(rng, dev):
        num_tiles = keys.numel() // cfg.tile
        threads, per_block, _ = rk.dest_scatter_geometry(cfg, num_tiles)
        hist = rk.tile_histograms(keys, 0, cfg)
        offsets = rk.global_offsets(hist)
        want = rk.dest_scatter(keys, hist, offsets, 0, cfg, columns, impl="reference")
        outs = [torch.empty_like(c) for c in columns]  # every build writes the same buffers
        fns = {}
        if "parent" in libs:
            fns["parent"] = launcher(libs["parent"], True, keys, hist, offsets, cfg, columns, outs,
                                     None)
        fns[f"port (P={per_block})"] = launcher(libs["port"], False, keys, hist, offsets, cfg,
                                                columns, outs, (threads, per_block))
        for p in PARTITIONS:
            if p != per_block and p * cfg.tile <= rk.MAX_PARTITION_ROWS:
                fns[f"P={p}"] = launcher(libs["port"], False, keys, hist, offsets, cfg, columns,
                                         outs, (forced_threads(cfg, p), p))
        variants_at = ["rank batch 16"] + (
            ["match_any"] if cfg.radix == 256 else [])
        for name in variants_at:
            fns[f"{name} (P={per_block})"] = launcher(libs[name], False, keys, hist, offsets, cfg,
                                                      columns, outs, (threads, per_block))
        fns["K4 + scatter_by_destination"] = lambda: scatter_by_destination(
            rk.tile_destinations(keys, offsets, 0, cfg), columns)
        for name, fn in fns.items():
            for o in outs:
                o.fill_(-1)
            if not all(torch.equal(g, w) for g, w in zip(fn(), want)):
                raise RuntimeError(f"{name} != plain, {label}")
        turns = {name: [] for name in fns}
        for order in (list(fns), list(fns)[::-1], list(fns)):
            for name in order:
                turns[name].append(1e3 * profiled_device_ms(fns[name], calls=20)[0])
        bound_us = 1e3 * bound_of(nbytes, 0)[0]
        entry = results[label] = {"bound_us": bound_us, "partition": per_block,
                                  "threads": threads, "us": {}, "turns": turns}
        for name, t in turns.items():
            us = float(np.median([x for x in t if x] or [0.0]))
            entry["us"][name] = us
            share = f"{bound_us / us:.3f}" if us else "not measured"
            print(f"[ab] {label}, {name}: {us:.2f} us (turns {', '.join(f'{x:.2f}' for x in t)}); "
                  f"bound {bound_us:.2f} us; share {share} ({card})", flush=True)
        del hist, offsets, want, fns, outs
        torch.cuda.empty_cache()
    return results


def sort_ab(libs, rng, dev, card: str) -> dict:
    """The radix method's sort_pairs through the parent's and the port's dest_scatter."""
    results = {}
    for label, n in (("2^24", 1 << 24), ("100M", 100_000_000)):
        keys = rng.integers(0, 2**32, n, dtype=np.uint32)
        for bits in (8, 4):
            cfg = EngineConfig(radix_bits=bits)
            col = make_key_column(keys, cfg, device=dev)
            runs = {}
            for side in ("parent", "port"):
                def run(lib=libs[side], parent=side == "parent"):
                    with mock.patch.object(rk, "launch", routed(lib, parent)), \
                            mock.patch.object(sort_ops, "GRAPH_MAX_PADDED", 0):
                        return sort_ops.sort_pairs(col, cfg, method="radix")
                runs[side] = run
            got = {side: run() for side, run in runs.items()}
            if not all(torch.equal(a.data, b.data) for a, b in zip(got["parent"], got["port"])):
                raise RuntimeError(f"the radix sorts differ, radix_bits {bits} @ {label}")
            order = np.argsort(keys, kind="stable")
            index = got["port"][1].data[:n].view(torch.int32).cpu().numpy()
            if not np.array_equal(index, order.astype(np.int32)):
                raise RuntimeError(f"the radix sort is wrong, radix_bits {bits} @ {label}")
            del got
            turns = {"parent": [], "port": []}
            for side in ("parent", "port", "port", "parent"):
                turns[side].extend(per_call_ms(runs[side], calls=2 if n > 1 << 24 else 5, reps=3))
            busy = {side: [] for side in turns}
            for side in ("parent", "port", "port", "parent"):
                busy[side].append(profiled_device_ms(runs[side], calls=3)[0])
            key = f"sort_pairs radix, radix_bits {bits} @ {label}"
            results[key] = {side: {"ms": float(np.median(t)),
                                   "busy_ms": float(np.median(busy[side]))}
                            for side, t in turns.items()}
            for side, t in turns.items():
                print(f"[ab] {key}, {side}: {results[key][side]['ms']:.4f} ms by CUDA events "
                      f"(median of {len(t)}: {', '.join(f'{x:.4f}' for x in t)}); device busy "
                      f"{results[key][side]['busy_ms']:.4f} ms a sort (profiler, turns "
                      f"{', '.join(f'{x:.4f}' for x in busy[side])}) ({card})", flush=True)
            del col, runs
            torch.cuda.empty_cache()
    return results


def operator_ab(libs, rng, dev, card: str) -> dict:
    """chip_smoke.py's 100M filter and inner join through the parent's and the port's kernel."""
    cfg = EngineConfig()
    n, nb = 100_000_000, 10_000_000

    def table(keys, **cols):
        t = Table({name: make_column(v, cfg, device=dev) for name, v in cols.items()})
        return t.with_column("key", make_key_column(keys, cfg, device=dev))

    ftable = table(rng.integers(0, 2**32, n, dtype=np.uint32))
    distinct = rng.permutation(np.unique(rng.integers(0, 2**32, nb * 23 // 20, dtype=np.uint32)))
    bkeys, misses = distinct[:nb], distinct[nb:]
    hit = np.minimum((nb * rng.random(n) ** 4).astype(np.int64), nb - 1)
    pkeys = np.where(rng.random(n) < 0.1, misses[rng.integers(0, misses.size, n)], bkeys[hit])
    probe = table(pkeys, pval=rng.integers(0, 2**31 - 1, n, dtype=np.int32))
    build = table(bkeys, payload=rng.integers(0, 2**31 - 1, nb, dtype=np.int32))
    del distinct, misses, hit, pkeys
    ops = {
        "filter_table + to_table, 100M keys": lambda: filter_table(
            ftable, lambda t: int32_bits(t["key"].data) >= 0, cfg).to_table(),
        "join inner + to_table, 100M probe x 10M build": lambda: join(
            probe, build, "key", "inner", cfg).to_table(),
    }
    results = {}
    for label, op in ops.items():
        runs = {}
        for side in ("parent", "port"):
            def run(lib=libs[side], parent=side == "parent", op=op):
                with mock.patch.object(rk, "launch", routed(lib, parent)):
                    return op()
            runs[side] = run
        got = {side: run() for side, run in runs.items()}
        if got["parent"].names() != got["port"].names() or not all(
                torch.equal(got["parent"][c].data, got["port"][c].data)
                for c in got["port"].names()):
            raise RuntimeError(f"{label}: the builds differ")
        del got
        turns = {"parent": [], "port": []}
        for side in ("parent", "port", "port", "parent"):
            turns[side].extend(per_call_ms(runs[side], calls=1, reps=3))
        results[label] = {side: float(np.median(t)) for side, t in turns.items()}
        for side, t in turns.items():
            print(f"[ab] {label}, {side}: {results[label][side]:.3f} ms by CUDA events (median "
                  f"of {len(t)}: {', '.join(f'{x:.3f}' for x in t)}) ({card})", flush=True)
        torch.cuda.empty_cache()
    return results


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--old", type=pathlib.Path,
                        help="a directory holding an older radix_dest.cu and its headers")
    parser.add_argument("--out", type=pathlib.Path, help="also write the JSON here")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("[ab] no CUDA device", flush=True)
        return 1
    dev = torch.device("cuda", 0)
    card = card_line()
    libs, reports = build_all(args.old)
    for name, lines in reports.items():
        for line in lines:
            print(f"[ab] ptxas {name} {line}", flush=True)
    rng = np.random.default_rng(SEED)
    results = {"card": card, "ptxas": reports, "cases": time_cases(libs, rng, dev, card)}
    if args.old is not None:
        results["sorts"] = sort_ab(libs, rng, dev, card)
        results["operators"] = operator_ab(libs, rng, dev, card)
    line = json.dumps(results)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    print(card, flush=True)
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
