"""The program's spans of one name that lie in this run's jobs, with their
arguments, for the readers that need more than a span's length
(:func:`perfbench.program_spans.per_job_ms` sums lengths alone)."""
from __future__ import annotations

import bisect

from perfbench import program_spans


def in_jobs(record, name: str, events=None):
    """(the complete events ``name`` inside this run's ``pipeline`` spans,
    the number of those pipelines), by :func:`program_spans.per_job_ms`'s
    rule: the session's last ``len(record["jobs"])`` pipelines. ([], 0)
    without a session, a job or a ``pipeline`` span."""
    events = program_spans.session_events() if events is None else events
    jobs = len(record.get("jobs") or ())
    if not events or not jobs:
        return [], 0
    pipes = sorted((e["ts"], e["ts"] + e["dur"]) for e in events if e["name"] == "pipeline")
    pipes = pipes[-jobs:]
    starts = [a for a, _ in pipes]
    found = []
    for e in events:
        if e["name"] != name:
            continue
        k = bisect.bisect_right(starts, e["ts"]) - 1
        if k >= 0 and e["ts"] + e["dur"] <= pipes[k][1]:
            found.append(e)
    return found, len(pipes)
