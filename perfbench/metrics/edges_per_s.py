"""edges_per_s: edges of every job completed in the window, over the
window's whole length (host clock, from the first job's submission to the
last job's indices on the host)."""
from perfbench import arith


def read(record):
    if not record["jobs"]:
        return None
    return arith.rate(record["jobs"], record["window_s"])
