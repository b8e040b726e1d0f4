"""device_peak_gib: ``torch.cuda.max_memory_allocated()`` over the window
alone (reset after set-up; the pool and the reference are outside it)."""


def read(record):
    peak = record["peak_bytes"]
    return None if peak is None else peak / 2**30
