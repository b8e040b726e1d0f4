"""merge_kernel_ms: per job, the program's ``merge.kernel`` span: the
merge's one-substream launch of the row-1 kernel over the recorded edges,
synchronised at its end. None where no such span lies in the run's jobs
(a program without the span, or no edge recorded)."""
from perfbench import job_spans


def read(record):
    spans, jobs = job_spans.in_jobs(record, "merge.kernel")
    if not spans:
        return None
    return sum(e["dur"] for e in spans) / jobs * 1e-3
