"""The plan's sorts' least bytes at the HBM peak, as a share of their kernels' device time.

The bytes (``qbench/probe.py``): each sort reads every live key once and
writes the sorted key and the permutation once, 12 bytes a live row,
whatever passes or launches do it.  The time: the profiled queries' device
time of the fused sort's kernels, the argument block, the pass plan and
the look-back passes (the plans' 4-bit sorts take the fused method).
"""

from qbench.devicetime import hbm_bound_s

KERNELS = ("sort_args_kernel", "sort_plan_kernel", "lookback_scatter_kernel")


def read(run):
    if run.trace is None or not run.sort_bytes:
        return None
    seconds = run.trace.kernel_s(KERNELS)
    if seconds <= 0:
        return None
    return hbm_bound_s(run.sort_bytes) / seconds * 100
