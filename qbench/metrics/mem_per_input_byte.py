"""The device's peak allocated bytes over the window, over the bytes of the resident columns."""


def read(run):
    if run.memory_peak_window is None:
        return None
    return run.memory_peak_window / run.resident_bytes
