"""The device's side of the yardstick: the peak, the card, and a profiled trace of queries.

Frozen copies, so that a later change to the port cannot move them:
``HBM_PEAK_TBS``, the bytes' arm of ``bound_of`` (``hbm_bound_s``) and
``card_line`` of ``gpuradixsort_tpu_torch/utils/timing.py``, and the
marker launches and retakes of its ``profiled_device_ms``.  ``profile_queries`` runs a fixed
number of queries under ``torch.profiler`` and reads its trace: every
device activity (kernels, copies, memsets) and the benchmark's own
annotations on the host, on one clock.
"""

from __future__ import annotations

import json
import os
import subprocess
import tempfile
from collections import Counter
from dataclasses import dataclass
from typing import Callable

import torch
from torch.profiler import ProfilerActivity, profile, record_function

HBM_PEAK_TBS = 3.35  # H100 SXM data sheet

# Profiles profile_queries takes before it gives up.
PROFILE_ATTEMPTS = 5
# On the H100 the profiler drops the records of a profile's first device
# activities while it records every launch (at times the first one, after a
# large sort the first three), so each profile opens with this many launches
# of a marker kernel (torch.cuda._sleep's), which are left out.
_MARKER = "spin_kernel"
_MARKERS = 16
_DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
QUERY_SPAN = "qbench.query"


def card_line() -> str:
    """The first card's name and power limit, as ``nvidia-smi`` gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    return out.splitlines()[0]


def hbm_bound_s(nbytes: int) -> float:
    """Seconds that moving ``nbytes`` takes at the HBM peak."""
    return nbytes / (HBM_PEAK_TBS * 1e12)


@dataclass
class Trace:
    """What the profiler saw of the profiled queries; times in seconds on the profiler's clock."""

    start: float  # the first query's start
    end: float  # the last query's end
    device: list  # (name, start, end) of each device activity inside the window
    spans: list  # (name, start, end) of each benchmark annotation on the host

    @property
    def window_s(self) -> float:
        return self.end - self.start

    def busy_s(self) -> float:
        """Seconds in which some device activity ran: the union of their intervals."""
        busy, reach = 0.0, self.start
        for _, s, e in sorted(self.device, key=lambda d: d[1]):
            s, e = max(s, reach), min(e, self.end)
            if e > s:
                busy += e - s
                reach = e
        return busy

    def kernel_s(self, names) -> float:
        """Device seconds of the activities whose name holds one of ``names``."""
        return sum(e - s for n, s, e in self.device if any(k in n for k in names))

    def idle_gaps(self) -> list[tuple[str, float]]:
        """Each gap between device activities, named by the innermost host span open as it starts."""
        gaps, reach = [], self.start
        for _, s, e in sorted(self.device, key=lambda d: d[1]) + [("", self.end, self.end)]:
            if s > reach:
                gaps.append((self._span_at(reach), s - reach))
            reach = max(reach, e)
        return gaps

    def _span_at(self, t: float) -> str:
        open_ = [(e - s, n) for n, s, e in self.spans if s <= t < e]
        return min(open_)[1] if open_ else "outside any query"


def _read(path: str, queries: int) -> Trace | None:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = [(e["name"], e["ts"] * 1e-6, (e["ts"] + e.get("dur", 0)) * 1e-6) for e in events
             if e.get("cat") == "user_annotation" and e.get("ph") == "X"]
    window = [(s, e) for n, s, e in spans if n == QUERY_SPAN]
    if len(window) != queries:
        return None
    start, end = min(s for s, _ in window), max(e for _, e in window)
    device = [(e["name"], e["ts"] * 1e-6, (e["ts"] + e.get("dur", 0)) * 1e-6) for e in events
              if e.get("cat") in _DEVICE_CATEGORIES and _MARKER not in e["name"]
              and e["ts"] * 1e-6 >= start]
    counts = Counter(n for n, _, _ in device if n)
    if not device or any(c % queries for c in counts.values()):
        return None  # records dropped: take the profile again
    return Trace(start, end, device, spans)


def profile_queries(run_query: Callable[[int], object], queries: int) -> Trace | None:
    """Run ``run_query(0..queries-1)`` under the profiler; its trace, or None if none was whole.

    A trace is whole when it has device activity and each activity's name
    occurs a multiple of ``queries`` times (every query launches the same
    kernels).  Each attempt runs the queries again.
    """
    for _ in range(PROFILE_ATTEMPTS):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(_MARKERS):
                torch.cuda._sleep(1)
            torch.cuda.synchronize()
            for i in range(queries):
                with record_function(QUERY_SPAN):
                    run_query(i)
            torch.cuda.synchronize()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            trace = _read(path, queries)
        finally:
            os.remove(path)
        if trace is not None:
            return trace
    return None
