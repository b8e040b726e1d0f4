"""part1_kernel_ms: per job, the time in which any device operation ran
inside the ``substream_match`` span (from the profiler's trace; by time,
not by kernel name, so a replacement kernel is counted too)."""
from perfbench import arith


def read(record):
    tr = record["trace"]
    if not tr or not tr["device"]:
        return None
    spans = [s for s in tr["spans"] if s[0] == "substream_match"]
    if not spans:
        return None
    busy = arith.Timeline((a, b) for _, a, b in tr["device"])
    return sum(busy.busy(a, b) for _, a, b in spans) / len(spans) * 1e3
