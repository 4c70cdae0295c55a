"""Run one benchmark cell once and print its result as one JSON line.

    python3 -m qbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  The cell (``BENCHMARK.json``) names a
configuration and a traffic mix; ``qbench/registry.py`` finds their
files, and the configuration names its runner
(``qbench/runners/<runner>.py``), which makes the tables from ``--seed``,
warms up, drives the window, and holds what it produced against the plain
reference.  With ``--trace 1`` the result carries the cell's per-layer
metrics, else its end-to-end ones.

The last line of stdout is the result; the numbers compared, each beside
its limit, are the last lines of stderr and the result's last key.  Exits
with code 2 and prints no result where the cell's cards are missing, and 3
where the process holds JAX or the JAX package once the window has closed.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

import torch  # noqa: E402

from qbench import devicetime, registry  # noqa: E402

# Caches of kernels compiled at run time stay at fixed places in the checkout.
os.environ["TRITON_CACHE_DIR"] = str(registry.ROOT / "build" / "qbench" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(registry.ROOT / "build" / "qbench" / "torch_extensions")

FORBIDDEN = ("jax", "jaxlib", "flax", "gpuradixsort_tpu")


def forbidden_modules() -> list[str]:
    """The modules of JAX or the JAX package this process holds, by whole top-level name."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def run_cell(bench: dict, cell: dict, seed: int, seconds: float, trace: bool,
             device="cuda:0", t0: float = _T0, **runner_args) -> tuple[dict, list[str]]:
    """One run of ``cell`` by its configuration's runner.

    Returns the result and the lines naming each number compared beside
    its limit.  ``device`` is where a one-card runner runs; ``runner_args`` go to the
    runner (``system=``: what answers the queries in the program's place).
    """
    config = registry.config(bench, cell["config"])
    runner = registry.module("runners", config["runner"])
    return runner.run_cell(bench, cell, config, seed, seconds, trace, device, t0, **runner_args)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    bench = registry.benchmark()
    cell = registry.workload(bench, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    print(f"card: {devicetime.card_line()}", file=sys.stderr)
    result, lines = run_cell(bench, cell, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"the process holds JAX or the JAX package: {', '.join(found)}", file=sys.stderr)
        return 3
    print(f"{args.workload} seed {args.seed}: {result['attempted']} queries, "
          f"{result['failed']} wrong, correct {result['correct']}", file=sys.stderr)
    for line in lines:
        print(line, file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
