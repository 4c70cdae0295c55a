"""The share of the rows the port's operators walk that are live, in %.

100 × Σ live / Σ walked over every site of the port's row counters
(``gpuradixsort_tpu_torch/utils/trace.py``: each sort of a key column,
compaction, probe search, payload gather and group-by aggregate counts
its buffer's live rows and the padded rows it walks), read at the end of
the run: warm-up, window and profiled queries, all of one mix.  None
where the port keeps no such counters or counted nothing.
"""


def read(run):
    try:
        from gpuradixsort_tpu_torch.utils import trace
    except ImportError:
        return None
    counts = trace.counters()["rows"].values()
    walked = sum(w for _, w in counts)
    if not walked:
        return None
    return sum(live for live, _ in counts) / walked * 100
