"""job_p95_ms: the 95th percentile of the latencies of all jobs of the
window, submission to indices on the host (host clock)."""
from perfbench import arith


def read(record):
    lat = [(j["t1"] - j["t0"]) * 1e3 for j in record["jobs"]]
    return arith.percentile(lat, 95) if lat else None
