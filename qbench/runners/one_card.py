"""A cell on one card: one client sends the mix's queries in a closed loop.

The run:

1. makes the configuration's tables on the device from the seed and hands
   them to the system under test, by default the port (``Port``) as padded
   columns;
2. warms up: the mix's ``warmup_queries`` queries, every shape the window
   runs (the kernel library's build in a fresh checkout, the allocator's
   pools, the sorts' CUDA graphs);
3. runs the mix's query stream for the window as one client: each query
   starts when the last answer is on the host.  Every answer is kept, and
   one query's every operator output (the query drawn from the seed among
   the first four, which the window runs in any case);
4. with ``trace``, runs ``profiled_queries`` more queries under the
   profiler, after the window, whose spans are timed without it;
5. frees the system's state, makes the tables again from the seed, and
   holds every answer and the kept operator outputs against the plain
   reference (``qbench/outcome.py``).
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from qbench import devicetime, outcome, registry, stream
from qbench.probe import Probe

KEPT_AMONG = 4  # the query whose operator outputs are kept is one of the window's first four


def load(tables: dict) -> dict:
    """The port's padded tables of the generated columns, each column let go once padded."""
    from gpuradixsort_tpu_torch.core.table import Table, make_column, make_key_column

    return {name: Table({c: (make_key_column if t.dtype == torch.uint32 else make_column)(t)
                         for c, t in ((c, cols.pop(c)) for c in list(cols))})
            for name, cols in tables.items()}


class Port:
    """The system under test: the query's plan over the port's padded tables."""

    def __init__(self, tables: dict, plan, reference):
        self.plan, self.db = plan, load(tables)

    def run(self, params: dict, probe) -> dict:
        return self.plan.run(self.db, params, probe)


def run_cell(bench: dict, cell: dict, config: dict, seed: int, seconds: float, trace: bool,
             device, t0: float, system=Port) -> tuple[dict, list[str]]:
    """One run of ``cell``; (the result, the lines naming each number compared and its limit).

    ``system(tables, plan, reference)`` makes what answers the queries:
    an object whose ``run(params, probe)`` returns an answer's rows.
    """
    device = torch.device(device)
    on_card = device.type == "cuda"
    mix = registry.traffic(cell["traffic"])
    gen = registry.module("gen", config["generator"])
    plan = registry.module("queries", mix["query"])
    reference = registry.module("reference", mix["query"])

    tables = gen.generate(config, seed, device)
    resident = gen.resident_bytes(tables)
    rows_per_query = sum(next(iter(tables[t].values())).shape[0] for t in plan.TABLES)
    answerer = system(tables, plan, reference)
    del tables
    warm = stream.queries(mix, [seed, 1])
    for _ in range(mix["warmup_queries"]):
        answerer.run(next(warm), Probe(None))
    if on_card:
        torch.cuda.synchronize(device)
        setup_peak = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t0

    queries = stream.queries(mix, [seed, 0])
    kept_at = int(np.random.default_rng([seed, 2]).integers(KEPT_AMONG))
    spans = {} if trace else None
    answers, latencies, kept = [], [], None
    start = time.perf_counter()
    done, paused = start, 0.0  # paused: the kept query's copies to the host
    while done - paused < start + seconds or kept is None:
        params = next(queries)
        probe = Probe(spans, keeping=len(answers) == kept_at)
        t = time.perf_counter()
        answers.append((params, answerer.run(params, probe)))
        done = time.perf_counter()
        latencies.append(done - t - probe.kept_s)
        paused += probe.kept_s
        if probe.keeping:
            kept = (params, probe.kept)
    window_s = done - start - paused
    peak_window = torch.cuda.max_memory_allocated(device) if on_card else None

    profiled, probes = None, []
    if trace and on_card:
        params = [next(queries) for _ in range(mix["profiled_queries"])]
        probes = [None] * len(params)
        outs = [None] * len(params)

        def one(i: int) -> None:
            probes[i] = Probe(None)
            outs[i] = answerer.run(params[i], probes[i])

        profiled = devicetime.profile_queries(one, len(params))
        answers += list(zip(params, outs))

    del answerer
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    ref = reference.Reference(gen.generate(config, seed, device))
    numbers, failed = outcome.verify(reference, ref, answers, kept)

    record = outcome.RunRecord(latencies, window_s, rows_per_query, resident, peak_window, setup_s,
                               spans, profiled, sum(p.sort_bytes for p in probes if p),
                               sum(p.compact_bytes for p in probes if p))
    dev = {"platform": "gpu" if on_card else device.type,
           "kind": torch.cuda.get_device_name(device) if on_card else device.type,
           "count": cell["chips"],
           "memory_peak_bytes": max(setup_peak, peak_window) if on_card else None}
    return outcome.result(bench, cell, trace, record, numbers, failed, len(answers), dev, paused)
