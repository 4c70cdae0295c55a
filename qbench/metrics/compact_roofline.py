"""The compactions' least bytes at the HBM peak, as a share of their kernels' device time.

The bytes (``qbench/probe.py``): every filter's and join's compaction
reads a mask byte and each moved column once a live input row, and writes
each moved column once a kept row.  The time: the profiled queries' device
time of the compaction's kernels, the histogram (K1), the scan (K5) and
``dest_scatter``.
"""

from qbench.devicetime import hbm_bound_s

KERNELS = ("radix_hist_kernel", "scan_kernel", "dest_scatter_kernel")


def read(run):
    if run.trace is None or not run.compact_bytes:
        return None
    seconds = run.trace.kernel_s(KERNELS)
    if seconds <= 0:
        return None
    return hbm_bound_s(run.compact_bytes) / seconds * 100
