"""part1_ns_per_edge: over the run's jobs, the total length of Part 1's
``kernel_edges.execute`` spans (the row-1 kernel's launch, synchronised)
over the edges they carry (their ``edges`` argument), in ns. None where no
such span with ``edges`` lies in the run's jobs (a program without the
argument)."""
from perfbench import job_spans


def read(record):
    spans, _ = job_spans.in_jobs(record, "kernel_edges.execute")
    spans = [e for e in spans if "edges" in (e.get("args") or {})]
    edges = sum(int(e["args"]["edges"]) for e in spans)
    if not edges:
        return None
    return sum(e["dur"] for e in spans) * 1e3 / edges
