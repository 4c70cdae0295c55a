"""The control of a cell: the reference, a precision below the stated one, in the program's place.

    python3 -m qbench.control --workload <name> --seeds <n> [<n> ...] [--seconds <s>]

Runs the cell as ``qbench.run`` does, once a seed, with ``Control`` in
place of the port, and prints each number compared beside its limit.  A
limit holds only where the control fails it on every seed; PERF.md gives
the readings the limits were set from.  The benchmark's own runs never run
this.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from qbench import registry
from qbench.run import run_cell


class Control:
    """The query's plain reference with ``low_precision`` set, answering in the program's place.

    It keeps its operator outputs where the program would.
    """

    def __init__(self, tables: dict, plan, reference):
        self.reference = reference.Reference(tables, low_precision=True)

    def run(self, params: dict, probe) -> dict:
        if probe.keeping:
            probe.kept = self.reference.operators(params)
        return self.reference.expect(params)[0]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("the control runs on a CUDA card", file=sys.stderr)
        return 2
    bench = registry.benchmark()
    cell = registry.workload(bench, args.workload)
    for seed in args.seeds:
        result, _ = run_cell(bench, cell, seed, args.seconds, False, system=Control)
        print(json.dumps({"workload": args.workload, "seed": seed, "control": True,
                          "correct": result["correct"], "attempted": result["attempted"],
                          "checks": result["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
