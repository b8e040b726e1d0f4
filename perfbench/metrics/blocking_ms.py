"""blocking_ms: per job, the ``mwm_blocked`` span less the
``substream_match`` span inside it: the stream's copy to the device, the
blocking sorts and permutes, and putting ``assigned`` back in stream order."""
from perfbench import arith


def read(record):
    tr = record["trace"]
    if not tr:
        return None
    t = arith.self_time(tr["spans"], "mwm_blocked", "substream_match")
    return None if t is None else t * 1e3
